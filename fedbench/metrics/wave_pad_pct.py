"""Share of the cohort engine's member-steps in the traced window that
trained padding, in %: 1 - (steps of real members on real batches) /
(padded wave width x steps, summed over the waves). The program counts
both while a profiler records (``repro_torch.common.trace.counts``:
``member_steps_live``, ``member_steps_run``); a program without those
counters reads nothing."""


def read(rec):
    if rec["trace"] is None:
        return None
    try:
        from repro_torch.common.trace import counts
    except ImportError:
        return None
    c = counts()
    run = c.get("member_steps_run", 0)
    if run <= 0 or "member_steps_live" not in c:
        return None
    return 100.0 * (1.0 - c["member_steps_live"] / run)
