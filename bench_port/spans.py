"""The program's spans (disvae_tpu_torch/utils/trace.py) as a traced
window left their tally: a span records only while the profiler does, and
set-up is untraced, so the tally holds the window's spans alone.

A checkout whose program has no spans reads nothing: the readers then
return None, as they do when the window's work count is 0 or when the
tally lacks the enclosing phase's span (`eval` for an eval, `train.epoch`
for an epoch) once for each unit of the window's work (then the tracing
is broken, or the tally holds other runs' spans too).
"""


def tally():
    """{name: (calls, seconds)}, or None without the program's spans."""
    try:
        import disvae_tpu_torch.utils.trace as trace
    except ImportError:
        return None
    return trace.tally()


def per_unit(cell, phase, name, unit):
    """Seconds of span `name` per unit of the window's work
    (`cell.work[unit]`, each unit one `phase` span); 0.0 when the phase
    ran without the span."""
    units = cell.work.get(unit)
    spans = tally()
    if not units or not spans or spans.get(phase, (0,))[0] != units:
        return None
    return spans.get(name, (0, 0.0))[1] / units
