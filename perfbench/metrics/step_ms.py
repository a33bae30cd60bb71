"""A training step's host time, in ms: the untraced stretch of a traced
run (``bench.Run.stretches``) over its steps, as ``train_step_ms`` is
taken over the whole window of an untraced run. It stands per layer in
the cells where the step spreads too widely from run to run for a bound
end to end (PERF.md)."""


def read(run, variant):
    plain = run.plain
    if not (plain and plain['items']):
        return None
    return 1e3 * plain['seconds'] / plain['items']
