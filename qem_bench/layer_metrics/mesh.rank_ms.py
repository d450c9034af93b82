"""parallel.mesh: host time of a rank's ``kicked.generate`` (the whole
request on the rank, its host copies included), averaged over the ranks
(their spans folded under ``mesh.rank<r>/``), ms; against ``call_p95_ms``
it shows what the driving process adds."""
from qem_bench.program_spans import per_span_ms


def read(run):
    return per_span_ms("host_s", "kicked.generate", "kicked.generate")
