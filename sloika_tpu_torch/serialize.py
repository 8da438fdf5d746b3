"""Model JSON and checkpoint loading for the port, with numpy alone
(cf. ``sloika_tpu/serialize.py``).

* **Model JSON**: the reference's interchange format, a nested layer
  description with optional parameter lists.
* **Checkpoint**: the JAX package's format (``sloika_tpu/serialize.py``
  :86-143).  A ``.npz`` whose ``params/<path>`` keys hold the flattened
  parameter tree (``sublayers/<i>/...`` for ``Serial``, ``sublayer/...``
  for ``Reverse``), with the optimiser state beside it (``opt/count``,
  ``opt/mu/<path>``, ``opt/nu/<path>`` for ADAMski and Adam,
  ``opt/vel/<path>`` for SGD), and ``{"model": <model JSON>, "meta": {...}}``
  in ``<path>.npz.json``.  A run can resume across the two packages in
  either direction.
"""
import json

import numpy as np
import torch

from sloika_tpu_torch import optim
from sloika_tpu_torch.nn import core as nn_core


def load_model_json(path_or_obj):
    """Load (layer, params_tree_or_None) from a JSON file path, file
    object or dict; the layer holds the parameters when there are any."""
    if isinstance(path_or_obj, dict):
        obj = path_or_obj
    elif hasattr(path_or_obj, "read"):
        obj = json.load(path_or_obj)
    else:
        with open(path_or_obj) as fh:
            obj = json.load(fh)
    return nn_core.from_json(obj)


def save_model_json(path, layer, params=True, indent=None):
    """Write the layer (and, by default, its parameters) as model JSON."""
    with open(path, "w") as fh:
        json.dump(layer.to_json(params), fh, indent=indent)


def unflatten_like(template, flat, what="checkpoint entries"):
    """Rebuild a tree shaped like ``template`` (a layer's
    :meth:`~sloika_tpu_torch.nn.core.Layer.param_tensors`) from a flat
    {'/'-joined path: array}, as ``sloika_tpu.serialize.unflatten_like``
    does.  The template keeps the place of layers without parameters
    (a ``Window``'s empty tree), which the flat paths cannot show.
    Raises unless the paths and shapes are the template's."""
    want = {k: tuple(p.shape) for k, p in nn_core.tree_items(template)}
    got = {k: tuple(np.shape(v)) for k, v in flat.items()}
    if got != want:
        raise ValueError("{} do not match the model: {} given, {} expected"
                         .format(what, got, want))

    def build(node, path):
        join = (lambda k: "{}/{}".format(path, k)) if path else str
        if isinstance(node, dict):
            return {k: build(v, join(k)) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(build(v, join(i)) for i, v in enumerate(node))
        return flat[path]
    return build(template, "")


def params_from_numpy(layer, tree):
    """Copy the JAX package's parameter tree, given as numpy arrays
    (gate-major ``(ngate, size, fan)`` as stored), into the port's
    modules.  Returns the layer."""
    layer.load_param_tree(tree)
    return layer


def flatten_tree(tree):
    """{'/'-joined path: numpy array} of a tree of tensors or arrays, in the
    JAX package's order (cf. ``sloika_tpu.serialize.flatten_tree``)."""
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v))
            for k, v in nn_core.tree_items(tree)}


def save_checkpoint(path, layer, opt_state=None, meta=None):
    """Write a checkpoint in the JAX package's format.

    :param path: output ``.npz`` path (model JSON goes to ``path + '.json'``)
    :param opt_state: optional :class:`sloika_tpu_torch.optim.OptState` or
        :class:`~sloika_tpu_torch.optim.SGDState`
    :param meta: optional JSON-compatible dict stored alongside
    """
    # np.savez appends '.npz' to suffix-less paths, which load_checkpoint
    # would then never find
    if not path.endswith(".npz"):
        raise ValueError("checkpoint path must end in .npz")
    flat = {"params/" + k: v
            for k, v in flatten_tree(layer.param_tree()).items()}
    if isinstance(opt_state, optim.SGDState):
        flat.update({"opt/vel/" + k: v
                     for k, v in flatten_tree(opt_state.vel).items()})
    elif opt_state is not None:
        flat["opt/count"] = np.asarray(opt_state.count, dtype=np.float32)
        flat.update({"opt/mu/" + k: v
                     for k, v in flatten_tree(opt_state.mu).items()})
        flat.update({"opt/nu/" + k: v
                     for k, v in flatten_tree(opt_state.nu).items()})
    np.savez(path, **flat)
    struct = {"model": layer.to_json(False), "meta": meta or {}}
    with open(path + ".json", "w") as fh:
        json.dump(struct, fh)


def _tensor_tree(layer, flat, prefix):
    """The ``prefix``-ed entries of ``flat`` as a tree of CPU tensors shaped
    like the layer's parameters."""
    sub = {k[len(prefix):]: torch.from_numpy(np.array(v, np.float32))
           for k, v in flat.items() if k.startswith(prefix)}
    return unflatten_like(layer.param_tensors(), sub,
                          "checkpoint entries {}*".format(prefix))


def load_checkpoint(path):
    """Load (layer, params_tree, opt_state_or_None) from a checkpoint
    written by either package; the layer holds the parameters and the
    optimiser state's tensors are on the CPU."""
    with open(path + ".json") as fh:
        struct = json.load(fh)
    layer, _ = nn_core.from_json(struct["model"])
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree = unflatten_like(layer.param_tensors(),
                          {k[len("params/"):]: v for k, v in flat.items()
                           if k.startswith("params/")}, "checkpoint entries "
                          "params/*")
    params_from_numpy(layer, tree)
    opt_state = None
    if any(k.startswith("opt/vel/") for k in flat):
        opt_state = optim.SGDState(vel=_tensor_tree(layer, flat, "opt/vel/"))
    elif "opt/count" in flat:
        opt_state = optim.OptState(
            count=torch.from_numpy(np.array(flat["opt/count"], np.float32)),
            mu=_tensor_tree(layer, flat, "opt/mu/"),
            nu=_tensor_tree(layer, flat, "opt/nu/"))
    return layer, tree, opt_state
