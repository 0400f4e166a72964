"""Kernel B's work count against the port's kernel table (PERF.md):
least times in ms at B, T, F, V and what bounds them."""
import pytest

from benchlib import spec


@pytest.mark.parametrize('dims,form,ms,by', [
    ((1000, 108, 2049, 401), 'float64', 5.2978, 'operations'),
    ((500, 108, 2049, 401), 'float64', 2.6489, 'operations'),
    ((1, 108, 2049, 401), 'float64', 0.0062, 'bytes'),
    ((500, 216, 1025, 401), 'float64', 2.6502, 'operations'),
])
def test_kernel_b_bound_matches_the_kernel_table(dims, form, ms, by):
    work = spec.kernel_table()['kernel_b']['work']
    s, bound_by = work.bound_s(*dims, form=form)
    assert round(1e3 * s, 4) == ms and bound_by == by


def test_kernel_b_without_continuum_counts_two_accumulators():
    work = spec.kernel_table()['kernel_b']['work']
    s, _ = work.bound_s(1000, 108, 2049, 401, continuum=False)
    assert round(1e3 * s, 4) == 10.5956
