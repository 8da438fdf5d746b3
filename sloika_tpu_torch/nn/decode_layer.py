"""In-graph forward-Viterbi layer (cf. ``sloika_tpu/nn/decode_layer.py``).

Treats its input as per-step state logits, applies a log-softmax, and runs
the stay/step/skip max-plus forward recursion as an eager loop over time
(the JAX package's ``lax.scan``), emitting the running Viterbi score vector
over kmer states at every step.
"""
import torch

from sloika_tpu_torch.nn.core import Layer, register
from sloika_tpu_torch.variables import nkmer, nstate, DEFAULT_NBASE


@register("decode")
class Decode(Layer):
    """Forward pass of a Viterbi decoder over kmer transducer logits
    (cf. ``sloika_tpu/nn/decode_layer.py:17-69``).

    Input features: ``nstate(k)`` per-step logits (column 0 = stay);
    output features: ``nkmer(k)`` running Viterbi scores.
    """

    def __init__(self, k, skip_pen=0.0, nbase=DEFAULT_NBASE):
        super().__init__()
        # skip moves need nbase**2 predecessor groups inside the kmer
        if k < 3:
            raise ValueError("Decode needs kmer length >= 3 for skip moves")
        self.k = k
        self.nbase = nbase
        self.skip_pen = skip_pen
        self.insize = nstate(k, nbase=nbase)
        self.size = nkmer(k, nbase=nbase)

    def forward(self, x):
        K, B = self.size, x.shape[1]
        lp = torch.log_softmax(x, dim=2)          # (T, B, nstate)

        def move_max(p, n):
            return torch.amax(p.reshape(B, n, K // n),
                              dim=1).repeat_interleave(n, dim=1)

        vscore = lp[0][:, 1:]
        out = [vscore]
        for lp_t in lp[1:]:
            step_s = move_max(vscore, self.nbase)
            skip_s = move_max(vscore, self.nbase ** 2) - self.skip_pen
            new = lp_t[:, 1:] + torch.maximum(step_s, skip_s)
            vscore = torch.maximum(new, vscore + lp_t[:, 0:1])
            out.append(vscore)
        return torch.stack(out)

    def _json_config(self):
        return {"k": self.k, "skip_pen": self.skip_pen, "nbase": self.nbase}

    @classmethod
    def _from_json(cls, obj):
        return cls(obj.get("k", 5), skip_pen=obj.get("skip_pen", 0.0),
                   nbase=obj.get("nbase", 4)), {}
