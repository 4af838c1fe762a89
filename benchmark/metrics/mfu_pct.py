"""Device: the model's operations a clip at the card's peaks, times the
clips served, over the traced window, in %.  The operations are those of
every conv, dense layer and attention product of the encoder on the
whole clip and the decoder on its whole latent, untiled
(``benchmark/reference/cvvae.operations``), each at the peak of the
precision the configuration runs it in: int8 convs at the int8 peak, the
rest at bf16's.  Tiling and kernels do not change this yardstick."""

from benchmark import work
from benchmark.reference.cvvae import operations


def read(tr):
    if tr.window_s <= 0 or tr.cfg is None:
        return None
    ideal = sum(ops / work.PEAK_OPS["int8" if int8 else "bf16"]
                for ops, int8 in operations(tr.cfg, tr.clip))
    return 100.0 * ideal * tr.requests / tr.window_s
