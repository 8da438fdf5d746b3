"""The port stands without jax and h5py, and never drops to the CPU on its
own."""
import subprocess
import sys

import pytest
import torch

from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch import models as tmodels

_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["h5py"] = None
import sloika_tpu_torch
import sloika_tpu_torch.basecall
import sloika_tpu_torch.serialize
import sloika_tpu_torch.models
import sloika_tpu_torch.cli.basecall
import sloika_tpu_torch.nn.fused_gru
import sloika_tpu_torch.ops.viterbi_kernel
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "h5py")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("ok")
"""


def test_port_imports_with_jax_and_h5py_blocked():
    cp = subprocess.run([sys.executable, "-c", _BLOCKED],
                        capture_output=True, text=True, timeout=120)
    assert cp.returncode == 0, cp.stderr
    assert cp.stdout.strip() == "ok"


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_cuda_basecaller_raises_without_a_gpu(device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    layer = tmodels.network_factory("raw_1_00_rGr")(
        klen=3, sd=0.5, sizes=(8, 8, 8, 8), stride=5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbc.Basecaller(layer, 3, device=device)
    # nothing was moved: the layer stays on the CPU it was built on
    assert all(p.device.type == "cpu" for p in layer.parameters())


def test_cli_device_cuda_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sloika_tpu_torch import serialize
    from sloika_tpu_torch.cli import basecall as tcli
    layer = tmodels.network_factory("raw_1_00_rGr")(
        klen=3, sd=0.5, sizes=(8, 8, 8, 8), stride=5)
    model = str(tmp_path / "m.json")
    serialize.save_model_json(model, layer)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["raw", model, str(tmp_path), "--kmer_len", "3"])
