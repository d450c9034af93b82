"""parallel.mesh: device time of the work every rank repeats for the whole
batch, the noise draw (``kicked.draws``) and the shots (``kicked.shots``),
a ``kicked.generate`` request, averaged over the ranks (their spans folded
under ``mesh.rank<r>/``), ms: the part of a call that does not shrink
with ranks."""
from qem_bench.program_spans import per_span_ms


def read(run):
    draws = per_span_ms("device_s", "kicked.frame/kicked.draws",
                        "kicked.generate")
    shots = per_span_ms("device_s", "kicked.readout/kicked.shots",
                        "kicked.generate")
    if draws is None or shots is None:
        return None
    return draws + shots
