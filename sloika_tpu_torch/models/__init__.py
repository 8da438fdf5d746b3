"""Model registry of the port (cf. ``sloika_tpu/models/__init__.py``).

Besides the named architectures, :func:`pretrained_standin` builds the
headline model's stand-in: the layer graph of the reference's
``pretrained.pkl`` at its widths — Convolution(1->128, winlen 11, stride 5,
tanh) -> Reverse(GRU 112) -> GRU 144 -> Reverse(GRU 112) -> Softmax(1025) —
with random weights from a numpy seed.  It costs 157,382.4 FLOP per input
sample (2 x 393,456 dense weights / stride 5).
"""
import importlib

REGISTRY = {
    "raw_1.00_rGr": "sloika_tpu_torch.models.raw_1_00_rGr",
    "raw_1_00_rGr": "sloika_tpu_torch.models.raw_1_00_rGr",
}

#: widths of pretrained.pkl's graph: conv, GRU, GRU, GRU
PRETRAINED_SIZES = (128, 112, 144, 112)


def network_factory(model):
    """Resolve a registered model name to its ``network`` factory."""
    if model not in REGISTRY:
        raise ValueError("Unknown model {!r}; known: {}".format(
            model, sorted(REGISTRY)))
    return importlib.import_module(REGISTRY[model]).network


def pretrained_standin(klen=5, sd=0.5, seed=0):
    """The headline model's graph at full width with seeded random
    weights (see the module docstring)."""
    return network_factory("raw_1_00_rGr")(
        klen=klen, sd=sd, winlen=11, stride=5, seed=seed,
        sizes=PRETRAINED_SIZES)
