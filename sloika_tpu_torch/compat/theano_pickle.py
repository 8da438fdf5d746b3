"""Load the reference's Theano-era pickled models without Theano
(cf. ``sloika_tpu/compat/theano_pickle.py``).

A reference model file is a pickle of whole layer objects whose parameters
sit in Theano shared variables.  :class:`_RefUnpickler` substitutes a stub
class for every ``sloika.*`` and ``theano.*`` global and records each
object's state; numpy arrays reconstruct natively.  :func:`convert` then
translates the stub graph into the port's layers, holding the same
parameter trees as the JAX package's converter gives.

Weight layouts (the reference's, flat, against the gate-major
``(ngate, size, fan)`` of the port and the JAX package):

* GRU, Forget, Genmut: block-wise, so a reshape;
* Lstm and LstmCIFG: row ``G*u + g`` is (unit u, gate g), the reference's
  in-step reshape (-1, S, G), so the rows are permuted;
* LstmO: block-wise (its step reshapes (-1, G, S));
* Scrn: alpha is the diagonal of its fixed decay matrix ``ssW``.

Only numpy's array reconstruction and a few harmless builtins pass through
to real globals: every other global becomes a stub, so unpickling a model
file runs no code of its own.  A pickle written by the reference's numpy
names ``numpy.core.multiarray``, which numpy 2 moved to ``numpy._core``; a
pickle written by numpy 2 names the new path.  Either loads under either
numpy.
"""
import _compat_pickle
import io
import pickle

import numpy as np

from sloika_tpu_torch import activations, nn


class _Stub:
    """Generic stand-in for an unpicklable class; records state."""

    def __init__(self, *args, **kwargs):
        self._stub_args = args

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_stub_state"] = state


class _StubFunction:
    """Stand-in for a module-level function named by a pickle global (the
    reference's activations)."""

    def __init__(self, module, name):
        self.module = module
        self.name = name

    def __call__(self, *a, **k):
        raise RuntimeError("stub function {} called".format(self.name))


#: numpy's home of the array-reconstruction globals in this numpy
_NUMPY_CORE = "numpy._core" if hasattr(np, "_core") else "numpy.core"

#: (module, name) of the real globals a model pickle may name
_PASSTHROUGH = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("copyreg", "_reconstructor"), ("_codecs", "encode"),
    ("collections", "OrderedDict"),
    ("builtins", "object"), ("builtins", "set"), ("builtins", "frozenset"),
    ("builtins", "bytearray"), ("builtins", "complex"),
    ("builtins", "slice"),
}


def _numpy_module(module):
    """``numpy.core.*`` and ``numpy._core.*`` as ``numpy.core.*``."""
    if module.startswith("numpy._core."):
        return "numpy.core." + module[len("numpy._core."):]
    return module


class _RefUnpickler(pickle.Unpickler):

    def find_class(self, module, name):
        # Python 2's names (copy_reg, __builtin__, ...) as pickle maps them
        if (module, name) in _compat_pickle.NAME_MAPPING:
            module, name = _compat_pickle.NAME_MAPPING[(module, name)]
        elif module in _compat_pickle.IMPORT_MAPPING:
            module = _compat_pickle.IMPORT_MAPPING[module]
        key = (_numpy_module(module), name)
        if key in _PASSTHROUGH:
            if key[0].startswith("numpy.core."):
                # numpy 2's numpy.core is a shim that warns on every use
                module = _NUMPY_CORE + key[0][len("numpy.core"):]
            return super().find_class(module, name)
        if module.split(".")[0] in ("numpy", "copyreg", "_codecs",
                                    "collections", "builtins"):
            raise pickle.UnpicklingError(
                "global {}.{} is not allowed in a model pickle".format(
                    module, name))
        if module.startswith("sloika.activation"):
            return _StubFunction(module, name)
        # a distinct stub class for each (module, name)
        return type(name, (_Stub,), {"_stub_name": "{}.{}".format(
            module, name), "_stub_module": module})


def load_raw(path_or_bytes):
    """Unpickle a reference model into a stub object graph."""
    if isinstance(path_or_bytes, bytes):
        return _RefUnpickler(io.BytesIO(path_or_bytes),
                             encoding="latin1").load()
    with open(path_or_bytes, "rb") as fh:
        return _RefUnpickler(fh, encoding="latin1").load()


# ---------------------------------------------------------------------------
# Stub graph -> the port's layers
# ---------------------------------------------------------------------------

def _shared_value(sv):
    """The ndarray inside a stubbed Theano shared variable
    (cf. ``sloika_tpu/compat/theano_pickle.py:81-95``)."""
    # TensorSharedVariable.__getstate__ keeps a 'container' whose 'storage'
    # is a one-element list holding the value
    container = getattr(sv, "container", None)
    if container is not None:
        storage = getattr(container, "storage", None)
        if storage is not None:
            return np.asarray(storage[0], dtype=np.float32)
    state = getattr(sv, "_stub_state", None)
    if state is not None:
        for item in _iter_arrays(state):
            return item
    raise ValueError("could not extract value from shared variable stub")


def _iter_arrays(obj, depth=0):
    if depth > 6:
        return
    if isinstance(obj, np.ndarray):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _iter_arrays(o, depth + 1)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _iter_arrays(o, depth + 1)
    elif hasattr(obj, "__dict__"):
        yield from _iter_arrays(obj.__dict__, depth + 1)


def _flag(obj, name, *values):
    """A layer flag (``has_bias``/``has_peep``): the pickled attribute
    where there is one (a fresh layer's zero peepholes still say
    ``has_peep``), else whether any of ``values`` is nonzero
    (cf. ``sloika_tpu/compat/theano_pickle.py:119-132``)."""
    v = getattr(obj, name, None)
    if v is not None:
        return bool(v)
    return bool(any(np.any(x) for x in values))


def _activation(obj, attr, default):
    name = getattr(getattr(obj, attr, None), "name", None)
    return default if name is None else activations.by_name(name)


def _fun(obj, default=activations.tanh):
    return _activation(obj, "fun", default)


def _gate(obj):
    return _activation(obj, "gatefun", activations.sigmoid)


def _loaded(layer, tree):
    """(layer, tree) with the layer holding the tree."""
    layer.load_param_tree(tree)
    return layer, tree


def _sublayers(cls, obj):
    subs = [convert(l) for l in obj.layers]
    return (cls([s[0] for s in subs]),
            {"sublayers": tuple(s[1] for s in subs)})


def _wrapper(cls, obj):
    sub, tree = convert(obj.layer)
    return cls(sub), {"sublayer": tree}


def _convolution(obj):
    W, b = _shared_value(obj.W), _shared_value(obj.b)
    size, insize, winlen = W.shape
    layer = nn.Convolution(insize, size, winlen, stride=obj.stride,
                           has_bias=_flag(obj, "has_bias", b),
                           fun=_fun(obj),
                           padding_mode=getattr(obj, "padding_mode", "same"))
    return _loaded(layer, {"W": W, "b": b})


def _affine(cls, obj, **kwargs):
    W, b = _shared_value(obj.W), _shared_value(obj.b)
    layer = cls(W.shape[1], W.shape[0], has_bias=_flag(obj, "has_bias", b),
                **kwargs)
    return _loaded(layer, {"W": W, "b": b})


def _gru(obj):
    iW = _shared_value(obj.iW)    # (3S, I) block-wise [z; r; h]
    sW = _shared_value(obj.sW)    # (2S, S) block-wise [z; r]
    sW2 = _shared_value(obj.sW2)
    b = _shared_value(obj.b)      # (3S,)
    S, I = sW2.shape[0], iW.shape[1]
    layer = nn.Gru(I, S, has_bias=_flag(obj, "has_bias", b), fun=_fun(obj),
                   gatefun=_gate(obj))
    return _loaded(layer, {"iW": iW.reshape(3, S, I),
                           "sW": sW.reshape(2, S, S), "sW2": sW2,
                           "b": b.reshape(3, S)})


def _recurrent(obj):
    iW, sW, b = (_shared_value(obj.iW), _shared_value(obj.sW),
                 _shared_value(obj.b))
    layer = nn.Recurrent(iW.shape[1], iW.shape[0],
                         has_bias=_flag(obj, "has_bias", b), fun=_fun(obj))
    return _loaded(layer, {"iW": iW, "sW": sW, "b": b})


_LSTMS = {"Lstm": (nn.Lstm, 4), "LstmCIFG": (nn.LstmCIFG, 3),
          "LstmO": (nn.LstmO, 3)}


def _lstm_rows(kind, G, S):
    """The reference's flat row of each gate-major row (g, u) of an LSTM
    of ``kind``: ``G*u + g`` for Lstm and LstmCIFG, whose step reshapes
    (-1, S, G) (reference layers.py:683-691); the identity for LstmO,
    block-wise (cf. ``sloika_tpu/compat/theano_pickle.py:222-248``)."""
    if kind == "LstmO":
        return np.arange(G * S)
    return (np.arange(S)[None, :] * G + np.arange(G)[:, None]).reshape(-1)


def _lstm(kind, obj):
    iW, sW, b, p = (_shared_value(obj.iW), _shared_value(obj.sW),
                    _shared_value(obj.b), _shared_value(obj.p))
    cls, G = _LSTMS[kind]
    S, I = iW.shape[0] // G, iW.shape[1]
    rows = _lstm_rows(kind, G, S)
    layer = cls(I, S, has_bias=_flag(obj, "has_bias", b),
                has_peep=_flag(obj, "has_peep", p), fun=_fun(obj),
                gatefun=_gate(obj))
    return _loaded(layer, {"iW": iW[rows].reshape(G, S, I),
                           "sW": sW[rows].reshape(G, S, S),
                           "b": b[rows].reshape(G, S), "p": p})


def _scrn(obj):
    isW = _shared_value(obj.isW)   # (slow, I)
    sfW = _shared_value(obj.sfW)   # (fast, slow)
    ifW = _shared_value(obj.ifW)   # (fast, I)
    ffW = _shared_value(obj.ffW)   # (fast, fast)
    # alpha lives in a Theano constant; the fixed decay matrix
    # ssW = alpha * I carries it (reference layers.py:545)
    ssW = _shared_value(obj.ssW)
    alpha = float(ssW[0, 0]) if ssW.size else 0.95
    layer = nn.Scrn(isW.shape[1], ifW.shape[0], isW.shape[0], alpha=alpha,
                    fun=_fun(obj, activations.sigmoid))
    return _loaded(layer, {"isW": isW, "sfW": sfW, "ifW": ifW, "ffW": ffW})


def _forget(obj):
    # block-wise (step reshape (-1, 2, S)); the reference never assigns
    # gatefun, so the sigmoid default applies
    iW, sW, b = (_shared_value(obj.iW), _shared_value(obj.sW),
                 _shared_value(obj.b))
    S = sW.shape[1]
    layer = nn.Forget(iW.shape[1], S, has_bias=_flag(obj, "has_bias", b),
                      fun=_fun(obj), gatefun=_gate(obj))
    return _loaded(layer, {"iW": iW.reshape(2, S, -1),
                           "sW": sW.reshape(2, S, S), "b": b.reshape(2, S)})


_MUTS = {"Mut1": nn.Mut1, "Mut2": nn.Mut2, "Mut3": nn.Mut3}


def _mut(kind, obj):
    # per-gate matrices under the port's names; separate bias vectors
    cls = _MUTS[kind]
    mats = {nm: _shared_value(getattr(obj, nm))
            for nm in cls._XMATS + cls._HMATS}
    biases = {nm: _shared_value(getattr(obj, nm))
              for nm in ("b_u", "b_z", "b_r", "b_h")}
    layer = cls(mats["W_xu"].shape[1], mats["W_xu"].shape[0],
                has_bias=_flag(obj, "has_bias", *biases.values()),
                fun=_fun(obj), gatefun=_gate(obj))
    return _loaded(layer, {**mats, **biases})


def _genmut(obj):
    # block-wise [u; r; z] (step reshape (-1, 3, S))
    xW, sW, sW2, b, b2 = (_shared_value(getattr(obj, nm))
                          for nm in ("xW", "sW", "sW2", "b", "b2"))
    S = sW2.shape[0]
    layer = nn.Genmut(xW.shape[1], S, has_bias=_flag(obj, "has_bias", b, b2),
                      fun=_fun(obj), gatefun=_gate(obj))
    return _loaded(layer, {"xW": xW.reshape(3, S, -1),
                           "sW": sW.reshape(3, S, S), "sW2": sW2,
                           "b": b.reshape(3, S), "b2": b2})


def _insize(obj):
    return getattr(obj, "_insize", 0)


_CONVERT = {
    "Serial": lambda o: _sublayers(nn.Serial, o),
    "Parallel": lambda o: _sublayers(nn.Parallel, o),
    "Reverse": lambda o: _wrapper(nn.Reverse, o),
    "Residual": lambda o: _wrapper(nn.Residual, o),
    "Convolution": _convolution,
    "Softmax": lambda o: _affine(nn.Softmax, o),
    "SoftmaxTheano": lambda o: _affine(nn.SoftmaxTheano, o),
    "FeedForward": lambda o: _affine(nn.FeedForward, o, fun=_fun(o)),
    "Gru": _gru,
    "Recurrent": _recurrent,
    "Lstm": lambda o: _lstm("Lstm", o),
    "LstmCIFG": lambda o: _lstm("LstmCIFG", o),
    "LstmO": lambda o: _lstm("LstmO", o),
    "Window": lambda o: (nn.Window(getattr(o, "insize", _insize(o)), o.w),
                         {}),
    "Identity": lambda o: (nn.Identity(_insize(o)), {}),
    "Studentise": lambda o: (nn.Studentise(_insize(o)), {}),
    "NormaliseL1": lambda o: (nn.NormaliseL1(_insize(o)), {}),
    "MaxPool": lambda o: (nn.MaxPool(_insize(o), o.pool_size, o.stride,
                                     padding_mode=getattr(o, "padding_mode",
                                                          "same")), {}),
    "Scrn": _scrn,
    "Forget": _forget,
    "Mut1": lambda o: _mut("Mut1", o),
    "Mut2": lambda o: _mut("Mut2", o),
    "Mut3": lambda o: _mut("Mut3", o),
    "Genmut": _genmut,
}


def convert(obj):
    """Translate a stub layer object into (port layer holding its
    parameters, parameter tree of numpy arrays) (cf.
    ``sloika_tpu/compat/theano_pickle.py:148-336``)."""
    kind = type(obj).__name__
    if kind not in _CONVERT:
        raise NotImplementedError(
            "cannot convert reference layer {!r}".format(kind))
    return _CONVERT[kind](obj)


def load_model(path):
    """Load a reference pickled model as (layer, params tree)."""
    return convert(load_raw(path))
