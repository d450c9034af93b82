"""workflows.zne_scale: host time of the sweep's engine constructions
(the program's ``kicked.engine`` spans inside ``zne.sweep``) a sweep,
ms."""
from qem_bench.program_spans import per_span_ms


def read(run):
    return per_span_ms("host_s", "zne.sweep/kicked.engine", "zne.sweep")
