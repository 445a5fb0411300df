"""Share of the traced window in which the device was idle while the server
policy (``repro_torch.sketch``, ``.receive``, ``.aggregate`` or
``.refresh``) was the innermost of the program's spans open, in %.
``fedbench.spans`` splits the window's idle time by span from the trace
the profiler hands it as it stops; a program without the spans reads
nothing."""
from fedbench import spans

spans.install()


def read(rec):
    return spans.idle_share(rec, "policy")
