"""Model JSON and checkpoint loading for the port, with numpy alone
(cf. ``sloika_tpu/serialize.py``).

* **Model JSON**: the reference's interchange format, a nested layer
  description with optional parameter lists.
* **Checkpoint**: a ``.npz`` whose ``params/<path>`` keys hold the JAX
  package's flattened parameter tree (``sublayers/<i>/...`` for ``Serial``,
  ``sublayer/...`` for ``Reverse``), with the model JSON in
  ``<path>.npz.json``.  Optimiser state in it is ignored.
"""
import json

import numpy as np

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


def unflatten_tree(flat):
    """{'a/0/b': array} -> nested tree; a level whose keys are all integers
    becomes a tuple in index order (the JAX package's flattening of
    tuples)."""
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(fix(node[k]) for k in sorted(node, key=int))
        return {k: fix(v) for k, v in node.items()}
    return fix(tree)


def params_from_numpy(layer, tree):
    """Copy the JAX package's parameter tree, given as numpy arrays
    (gate-major ``(ngate, size, fan)`` as stored), into the port's
    modules.  Returns the layer."""
    layer.load_param_tree(tree)
    return layer


def load_checkpoint(path):
    """Load (layer, params_tree) from a checkpoint written by
    ``sloika_tpu.serialize.save_checkpoint``."""
    with open(path + ".json") as fh:
        struct = json.load(fh)
    layer, _ = nn_core.from_json(struct["model"])
    with np.load(path) as z:
        flat = {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}
    tree = unflatten_tree(flat)
    params_from_numpy(layer, tree)
    return layer, tree
