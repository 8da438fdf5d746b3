"""What the harness takes from the measured program: its network built by
name, the benchmark's weights copied into it, and its launch counters."""
import torch


def network(config):
    """The program's network for a configuration (``port_model``: a
    registered model name, or ``pretrained_standin``), its weights to be
    replaced by :func:`load_weights`."""
    from sloika_tpu_torch import models
    spec = config["port_model"]
    args = dict(spec.get("args", {}))
    if spec["name"] == "pretrained_standin":
        return models.pretrained_standin(**args)
    return models.network_factory(spec["name"])(**args)


def _sublayers(layer):
    for sub in layer.layers:
        yield getattr(sub, "layer", sub)     # a Reverse holds its layer


def load_weights(layer, params):
    """Copy the benchmark's {``<i>.<name>``: tensor} into the network's
    parameters, shape for shape."""
    with torch.no_grad():
        for i, sub in enumerate(_sublayers(layer)):
            for name, p in sub.named_parameters(recurse=False):
                src = params["{}.{}".format(i, name)]
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError("{}.{}: {} against {}".format(
                        i, name, tuple(src.shape), tuple(p.shape)))
                p.copy_(src)
    return layer


def named_tree(layer, tree):
    """{``<i>.<name>``: tensor} of a parameter-shaped tree of the network
    (its parameters, or an optimiser's moments)."""
    out = {}
    for i, (sub, t) in enumerate(zip(_sublayers(layer), tree["sublayers"])):
        t = t.get("sublayer", t)
        for name in dict(sub.named_parameters(recurse=False)):
            out["{}.{}".format(i, name)] = t[name]
    return out


def counters():
    """{wrapper: {counter: n}} of the program's kernel launch counters."""
    from sloika_tpu_torch import training
    out = {}
    for w in training.kernel_wrappers():
        name = type(w).__name__
        out[name] = {c: getattr(w, c) for c in
                     ("launches", "general_launches", "wide_launches")
                     if hasattr(w, c)}
    return out
