"""Percent of the driver's main thread's time in its groups (the
program's counter ``driver.group.ns``) spent waiting for the next
group's prep (``driver.prep_wait.ns``) or for the writer
(``driver.write_wait.ns``), over the whole run."""
from benchlib import program_trace as pt


def read(ctx, win, dtrace):
    c = pt.counters(dtrace)
    if not c or not c.get('driver.group.ns'):
        return None
    waits = c.get('driver.prep_wait.ns', 0) + c.get('driver.write_wait.ns', 0)
    return 100.0 * waits / c['driver.group.ns']
