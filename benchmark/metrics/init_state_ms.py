"""init_state_ms: the mean host length of ``state.init_state`` (the span
``init_state``: the codes and batch tables on the host, their copies, the
normalised embedding, the state's buffers) over the profiled slice's jobs
(torch.profiler's trace; host NumPy, which the profiler does not slow)."""

from benchmark.context import note


def read(ctx):
    s = ctx.slice
    if s is None or not s.device or not ctx.profiled:
        return None
    spans = [d for cat, name, _, d in s.host if cat == "user_annotation" and name == "init_state"]
    if not spans:
        return None
    if len(spans) != len(ctx.profiled):
        note(f"init_state_ms: {len(spans)} init_state spans in the slice against "
             f"{len(ctx.profiled)} profiled jobs")
        return None
    return 1e-3 * sum(spans) / len(spans)
