"""The plain reference's layer kinds, one module a kind, found by the
``type`` of a configuration's layer: a layer ``{"type": "gru", ...}`` is
``benchmark/reference/layers/gru.py``.  A new kind is a new file here; no
file of the harness changes.

A kind's module gives, for a layer's ``spec`` (its entry of the
configuration's ``layers``) at index ``i`` of the network:

* ``param_shapes(spec, i)``: [(name, shape, fan scale)] of its parameters
  in the order the benchmark draws them, each named ``"<i>.<name>"`` as
  the program's layer names it; the scale is sloika's initialiser divisor
  (the fan of each weight; biases 1);
* ``flops(spec)``: forward FLOPs a frame at the layer's input rate, every
  element of a dense weight one multiply-accumulate (2 FLOPs) a frame it is
  applied to, a strided layer charging its output frame to ``stride``
  input frames; biases and elementwise work left out;
* ``stride(spec)``: the layer's temporal stride;
* ``out_lengths(spec, lengths)``: the frames a row of ``lengths`` input
  frames gives (an array or a tensor);
* ``forward(spec, p, i, x, lengths, prec)``: the layer over a (T, B, I)
  float32 batch whose rows are valid up to ``lengths`` at its input rate
  (None: every row whole, with no look at the device's values), in plain
  PyTorch, its products' operands through ``prec.operand``
  (:class:`benchmark.reference.model.Precision`);
* optionally ``head_weights(spec, i, p, scheme)``: where the layer is the
  network's last, how the traffic's weight ``scheme`` adjusts its drawn
  parameters ``p`` in place.

A kind imports nothing of the measured program and nothing of the JAX
package.
"""
import importlib


def kind(name):
    """The module of layer kind ``name``; raises ValueError, naming the file
    to add, where there is none."""
    module = "{}.{}".format(__name__, name)
    if not name.isidentifier():
        raise ValueError("layer type {!r} is not a module name".format(name))
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(
            "no layer kind {!r}: add benchmark/reference/layers/{}.py (see "
            "benchmark/reference/layers/__init__.py)".format(name, name))
