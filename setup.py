"""Package setup for sloika_tpu.

Builds the native C++ helper library alongside the Python package and
installs console entry points mirroring the reference's bin/ scripts.
"""
import subprocess
import sys

from setuptools import setup, find_packages
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "native/sloika_native.cpp", "-o",
                 "native/libsloika_native.so"], check=True)
        except Exception as e:
            sys.stderr.write("native build skipped: {}\n".format(e))
        super().run()


setup(
    name="sloika_tpu",
    version="0.1.0",
    description="TPU-native nanopore basecaller training framework",
    packages=find_packages(include=["sloika_tpu", "sloika_tpu.*",
                                    "sloika_tpu_torch",
                                    "sloika_tpu_torch.*"]),
    # the PyTorch port's CUDA sources, compiled by nvcc at first use
    package_data={"sloika_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "h5py", "scipy"],
    extras_require={"torch": ["torch"]},
    cmdclass={"build_py": BuildWithNative},
    entry_points={
        "console_scripts": [
            "sloika-train=sloika_tpu.cli.train:main",
            "sloika-basecall=sloika_tpu.cli.basecall:main",
            "sloika-chunkify=sloika_tpu.cli.chunkify:main",
            "sloika-validate=sloika_tpu.cli.validate:main",
            "sloika-verify=sloika_tpu.cli.verify:main",
            "sloika-dump-json=sloika_tpu.cli.dump_json:main",
            "sloika-align=sloika_tpu.cli.align:main",
            "sloika-extract-reference=sloika_tpu.cli.extract_reference:main",
            "sloika-get-refs-from-sam=sloika_tpu.cli.get_refs_from_sam:main",
            "sloika-model-convert=sloika_tpu.cli.model_convert:main",
            "sloika-torch-basecall=sloika_tpu_torch.cli.basecall:main",
            "sloika-torch-train=sloika_tpu_torch.cli.train:main",
        ],
    },
)
