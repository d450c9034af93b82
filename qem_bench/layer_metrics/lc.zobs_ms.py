"""ops.lightcone: device time of the program's per-step ⟨Z_obs⟩ reads
(``lightcone.z`` spans) inside the noisy arm's evolutions a chunk
(``lightcone.chunk``), ms."""
from qem_bench.program_spans import per_span_ms


def read(run):
    return per_span_ms("device_s",
                       "lightcone.chunk/lightcone.evolve/lightcone.z",
                       "lightcone.chunk")
