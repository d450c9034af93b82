"""parallel.mesh: device time of the program's ``mesh.gather`` spans (the
all-gathers of the trajectories' ⟨Z⟩ and of the ideal labels, waits for
the slowest rank included) a ``kicked.generate`` request, averaged over
the ranks (their spans folded under ``mesh.rank<r>/``), ms."""
from qem_bench.program_spans import per_span_ms


def read(run):
    return per_span_ms("device_s", "mesh.gather", "kicked.generate")
