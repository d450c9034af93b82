"""workflows.zne_scale: host time of the Pauli twirl of the bonds' CX
channels while the sweep's engines are built (the program's
``trajectory.twirl`` spans inside ``kicked.engine``) a sweep, ms."""
from qem_bench.program_spans import per_span_ms


def read(run):
    return per_span_ms("host_s", "zne.sweep/kicked.engine/trajectory.twirl",
                       "zne.sweep")
