"""Model registry of the port (cf. ``sloika_tpu/models/__init__.py``).

A model is a registered name of :data:`REGISTRY` or a path to a ``.py``
model file whose ``network`` takes the registered models' keywords and
``seed`` (see :mod:`sloika_tpu_torch.module_tools`).  Besides the named
architectures, :func:`pretrained_standin` builds the
headline model's stand-in: the layer graph of the reference's
``pretrained.pkl`` at its widths — Convolution(1->128, winlen 11, stride 5,
tanh) -> Reverse(GRU 112) -> GRU 144 -> Reverse(GRU 112) -> Softmax(1025) —
with random weights from a numpy seed.  It costs 157,382.4 FLOP per input
sample (2 x 393,456 dense weights / stride 5).
"""
import importlib
import importlib.util
import os

REGISTRY = {
    "tiny_gru": "sloika_tpu_torch.models.tiny_gru",
    "baseline_gru": "sloika_tpu_torch.models.baseline_gru",
    "baseline_lstm": "sloika_tpu_torch.models.baseline_lstm",
    "baseline_raw_gru": "sloika_tpu_torch.models.baseline_raw_gru",
    "bigger_raw_gru": "sloika_tpu_torch.models.bigger_raw_gru",
    "raw_0.98_rgrgr": "sloika_tpu_torch.models.raw_0_98_rgrgr",
    "raw_0_98_rgrgr": "sloika_tpu_torch.models.raw_0_98_rgrgr",
    "raw_1.00_rGr": "sloika_tpu_torch.models.raw_1_00_rGr",
    "raw_1_00_rGr": "sloika_tpu_torch.models.raw_1_00_rGr",
    # the port's alone: bonito's CRF-LSTM (the JAX package has no CRF)
    "bonito_crf": "sloika_tpu_torch.models.bonito_crf",
}

#: widths of pretrained.pkl's graph: conv, GRU, GRU, GRU
PRETRAINED_SIZES = (128, 112, 144, 112)


def network_factory(model):
    """Resolve a registered model name or a ``.py`` model file to its
    ``network`` factory (cf. ``sloika_tpu/models/__init__.py:28-38``)."""
    if model in REGISTRY:
        return importlib.import_module(REGISTRY[model]).network
    if model.endswith(".py") and os.path.exists(model):
        spec = importlib.util.spec_from_file_location("netmodule", model)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.network
    raise ValueError("Unknown model {!r}; known: {}".format(
        model, sorted(REGISTRY)))


def pretrained_standin(klen=5, sd=0.5, seed=0, nbase=4):
    """The headline model's graph at full width with seeded random
    weights (see the module docstring); over ``nbase`` bases its softmax
    has nbase^klen + 1 states (3,126 at nbase 5, a modified-base
    alphabet)."""
    return network_factory("raw_1_00_rGr")(
        klen=klen, sd=sd, nbase=nbase, winlen=11, stride=5, seed=seed,
        sizes=PRETRAINED_SIZES)
