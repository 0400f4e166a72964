"""Device and dtype policy of the port.

Entry points run on the CUDA card unless the caller passes
``device='cpu'``: a ``device=None`` argument resolves through
:func:`resolve_device`, which raises where there is no card (there is
no silent CPU fallback).

The working dtype is float64 (complex128) on the CPU and on the card
alike: the fit's results on the H100 are those of the reference's
float64 path.  float32 on the card moved them: the CCF's contraction
has terms of ~4e6 while its chi-square rises by 0.1-3 from one velocity
step to the next, and the Nelder-Mead ends anywhere inside its
tolerance along flat directions (ROADMAP C.1 and C.2, repaired by this
policy).  The card's kernels take float64 (kernel B on the FP64 tensor
cores) and keep their float32 forms, which a caller still reaches by
building its template model and CCF bank with an explicit
``dtype=torch.float32`` (pipeline/library.template_model_from_artifacts,
convert.ccf_bank).

TF32 is switched off for matmuls AND for cuDNN convolutions, for the
float32 forms: the spline solve's banded inverse is a conv1d
(ops/spline.py), and TF32 keeps ~3 decimal digits, which corrupts the
spline coefficients; the reference found that reduced-precision
matmuls also break the grid interpolation and the chi-square
(docs/performance.md, "Precision").

Worker threads (the drivers' overlaps, parallel/mesh) start with
:func:`enter_device`: the current CUDA device is per thread, and the C
launchers launch on it.  :class:`Background` runs a job on such a
thread and on a CUDA stream of its kind (:func:`side_stream`).
"""
import copy
import dataclasses
import threading

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')


def default_device():
    """The device of a call that names none: the current CUDA card, or
    in a multi-process run (``LOCAL_RANK`` set, or a world opened by
    parallel/distributed) card ``rank % device_count()``, so that the
    ranks of one host share its cards out.

    Raises RuntimeError when torch sees no CUDA device; a caller that
    wants the CPU asks for it with ``device='cpu'``."""
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass '
                           "device='cpu' to run on the CPU")
    from rvspecfit_torch.parallel.distributed import local_rank
    rank = local_rank()
    if rank is None:
        return torch.device('cuda')
    return torch.device('cuda', rank % torch.cuda.device_count())


def resolve_device(device):
    """``device`` as a torch.device, :func:`default_device` if None."""
    return default_device() if device is None else torch.device(device)


def dtype_for(device):
    """Working real dtype of tensors on ``device``: float64 on every
    device."""
    return torch.float64


def complex_dtype_for(device):
    """Working complex dtype of tensors on ``device``: complex128 on
    every device."""
    return torch.complex128


def complex_of(dtype):
    """The complex dtype whose parts are ``dtype`` (float32 or
    float64)."""
    return {torch.float32: torch.complex64,
            torch.float64: torch.complex128}[dtype]


def map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to every tensor in it: tensors,
    modules (copied, then their parameters and buffers mapped),
    dataclasses (their init fields) and tuples of them; anything else as
    it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj)._apply(fn)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(map_tensors(x, fn) for x in obj)
    return obj


def concrete(device):
    """``device`` with its index: a CUDA device named without one is the
    calling thread's current card (the meaning it has there, which a
    worker thread, whose current card starts at 0, would not share)."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def enter_device(device):
    """The first statement of every worker thread: make ``device`` the
    thread's current CUDA device (the C launchers launch on the current
    device, which is per thread).  Nothing for a CPU device."""
    device = concrete(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)


_side_streams = {}
_side_streams_lock = threading.Lock()


def side_stream(device, kind):
    """The CUDA stream of jobs of ``kind`` on ``device``, made once per
    process: cuBLAS keeps a workspace (tens of MB) for every stream a
    handle has run on, so jobs reuse their kind's stream rather than
    take a new one each.  The stream has a high priority: a job's
    chains of small kernels (the group's tail, the next group's prep)
    go ahead of the main thread's Nelder-Mead graph replays, which
    keep the card busy, rather than wait behind them."""
    device = concrete(device)
    with _side_streams_lock:
        if (device, kind) not in _side_streams:
            _side_streams[device, kind] = torch.cuda.Stream(device,
                                                            priority=-1)
        return _side_streams[device, kind]


class Background:
    """``fn()`` on a new daemon thread ``name``, on the CUDA stream of
    jobs of that name (:func:`side_stream`), not the caller's.

    The thread enters ``device`` first (:func:`enter_device`).  Its
    stream starts after everything the calling thread had enqueued on
    its current stream of ``device`` when the job was made (one event),
    so the job reads what the caller made before; the thread waits for
    its stream before it ends, so every tensor the job used is free to
    reuse once :meth:`result` returns.  :meth:`result` joins the thread
    and returns ``fn``'s value or raises its exception, on every call.
    On the CPU the job runs on the thread alone."""

    def __init__(self, fn, device, name='rvst-job'):
        self.device = concrete(device)
        self._ready = None
        if self.device.type == 'cuda':
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(self.device))
        self._value = self._exc = None
        self._kind = name
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        name=name, daemon=True)
        self._thread.start()

    def _run(self, fn):
        try:
            enter_device(self.device)
            if self._ready is None:
                self._value = fn()
                return
            stream = side_stream(self.device, self._kind)
            stream.wait_event(self._ready)
            try:
                with torch.cuda.stream(stream):
                    self._value = fn()
            finally:
                stream.synchronize()
        except BaseException as exc:       # re-raised by result()
            self._exc = exc

    def wait(self):
        """Join the thread, whatever the job did."""
        self._thread.join()

    def result(self):
        self.wait()
        if self._exc is not None:
            raise self._exc
        return self._value
