"""The zoo's routes on the card, and the pickle bridge's guards.

This file imports no jax, so the ``gpu``-marked tests run on a machine with
a CUDA card and without jax::

    python -m pytest tests/test_torch_zoo_card.py -m gpu --noconftest -q

On the card: the scan route's counter (a relu GRU takes the scan, the
tanh GRU the kernel, each counted where it runs), and the headline graph
read back from a reference-layout pickle giving the directly built
stand-in's posterior bit for bit.  On the CPU: the same counter, and the
unpickler's guards (numpy's two module paths, code globals refused).
"""
import io
import pickle
import warnings

import numpy as np
import pytest
import torch

import chip_smoke as cs
from sloika_tpu_torch import activations as tact
from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch import models as tmodels
from sloika_tpu_torch import nn as tnn
from sloika_tpu_torch.compat import theano_pickle as tp
from sloika_tpu_torch.nn import rnn as trnn
from sloika_tpu_torch.nn.fused_gru import gru_forward


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _grus(seed=3):
    init = tnn.truncated_normal(0.5, np.random.RandomState(seed))
    tanh = tnn.Gru(6, 16, init=init, has_bias=True)
    relu = tnn.Gru(6, 16, init=init, has_bias=True, fun=tact.relu)
    x = torch.from_numpy(np.random.RandomState(seed).normal(
        size=(40, 3, 6)).astype(np.float32))
    return tanh, relu, x


def _routes(tanh, relu, x):
    """(scan calls, kernel launches) of the tanh GRU, then the relu GRU."""
    counts = []
    for layer in (tanh, relu):
        scan, launches = trnn.scan_route.calls, gru_forward.launches
        with torch.inference_mode():
            layer(x, reverse=True)
        counts.append((trnn.scan_route.calls - scan,
                       gru_forward.launches - launches))
    return counts


def test_scan_route_counter_on_the_cpu():
    """On the CPU the kernel route runs its plain twin and counts no
    launch; the relu GRU counts one scan."""
    assert _routes(*_grus()) == [(0, 0), (1, 0)]


@pytest.mark.gpu
def test_scan_route_counter_on_the_card(cuda_device):
    tanh, relu, x = _grus()
    tanh.to(cuda_device), relu.to(cuda_device)
    assert _routes(tanh, relu, x.to(cuda_device)) == [(0, 1), (1, 0)]


@pytest.mark.gpu
def test_pickled_standin_equals_the_standin_on_the_card(cuda_device,
                                                        tmp_path):
    """The headline graph at full width, pickled in the reference's layout
    and read back by ``load_model``: its floored posterior on the card is
    the directly built stand-in's, bit for bit."""
    from sloika_tpu_torch.cli.basecall import load_model
    standin = tmodels.pretrained_standin(seed=1)
    path = str(tmp_path / "standin.pkl")
    with open(path, "wb") as fh:
        fh.write(cs.write_reference_pickle(standin))
    loaded = load_model(path)
    x = torch.from_numpy(np.random.RandomState(2).normal(
        size=(5000, 2, 1)).astype(np.float32)).to(cuda_device)
    lengths = torch.tensor([5000, 3100], device=cuda_device)
    posts = []
    for layer in (standin, loaded):
        caller = tbc.Basecaller(layer, 5, device=cuda_device)
        with torch.inference_mode():
            posts.append(caller._floored_masked_post(x, lengths)[0])
    assert torch.equal(*posts)


def _feed_forward_pickle():
    layer = tnn.FeedForward(3, 4, has_bias=True)
    with torch.no_grad():
        layer.W.copy_(torch.arange(12, dtype=torch.float32).reshape(4, 3))
    return layer, cs.write_reference_pickle(layer)


@pytest.mark.parametrize("module", ["numpy.core.multiarray",
                                    "numpy._core.multiarray"])
def test_either_numpy_path_loads_quietly(module):
    layer, blob = _feed_forward_pickle()
    blob = blob.replace(b"cnumpy.core.multiarray\n",
                        "c{}\n".format(module).encode())
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        port, tree = tp.convert(tp.load_raw(blob))
    assert np.array_equal(tree["W"], layer.W.detach().numpy())
    assert type(port) is tnn.FeedForward and port.has_bias


@pytest.mark.parametrize("obj", [eval, print, getattr, np.load])
def test_code_globals_are_refused(obj):
    """A global of numpy or the builtins that is not one of array
    reconstruction's is refused."""
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        tp.load_raw(pickle.dumps(obj, protocol=2))


def test_other_globals_become_inert_stubs():
    """Any other module's global becomes a stub class, as in the JAX
    loader: loading calls nothing of the module."""
    import os
    stub = tp.load_raw(pickle.dumps(os.system, protocol=2))
    assert isinstance(stub, type) and issubclass(stub, tp._Stub)
    assert stub.__name__ == "system"


def test_python_2_module_names_map_to_python_3():
    """A pickle from the reference's Python 2 names ``copy_reg`` and
    ``__builtin__``; they map as pickle maps them."""
    blob = (b"\x80\x02ccopy_reg\n_reconstructor\nq\x00csloika.layers\n"
            b"Identity\nq\x01c__builtin__\nobject\nq\x02N\x87q\x03Rq\x04}"
            b"q\x05U\x07_insizeq\x06K\x05sb.")
    layer, tree = tp.convert(tp.load_raw(blob))
    assert type(layer) is tnn.Identity and layer.insize == 5 and tree == {}


def test_stub_functions_are_never_called():
    obj = tp.load_raw(io.BytesIO(cs.write_reference_pickle(
        tnn.FeedForward(3, 4))).getvalue())
    with pytest.raises(RuntimeError, match="stub function tanh"):
        obj.fun(0.0)
