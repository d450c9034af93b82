"""ops.kernels (K3's wide tier): device time of the program's
``kicked.step`` spans inside the noisy arm's evolutions a chunk
(``lightcone.chunk``, one ``run_noisy`` call), ms."""
from qem_bench.program_spans import per_span_ms


def read(run):
    return per_span_ms("device_s",
                       "lightcone.chunk/lightcone.evolve/kicked.step",
                       "lightcone.chunk")
