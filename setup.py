import os

from setuptools import find_packages, setup

here = os.path.abspath(os.path.dirname(__file__))
with open(os.path.join(here, "README.md"), encoding="utf-8") as f:
    long_description = f.read()

setup(
    name="esoo-tpu",
    version="0.1.0",
    description=("TPU-native orbital-optimized quantum eigensolvers "
                 "(OptOrbVQE / OptOrbSSVQE / OptOrbMCVQE / OptOrbVQD / "
                 "OptOrbAdaptVQE) built on JAX"),
    long_description=long_description,
    long_description_content_type="text/markdown",
    license="Apache-2.0",
    packages=find_packages(include=["esoo_tpu", "esoo_tpu.*",
                                    "esoo_torch", "esoo_torch.*"]),
    package_data={"esoo_tpu.native": ["*.cpp"],
                  "esoo_torch": ["csrc/*.cu"],
                  "esoo_torch.native": ["*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "numpy>=2.0",
        "scipy>=1.10",
    ],
    extras_require={
        "dev": ["pytest>=7"],
        # the PyTorch/CUDA port (esoo_torch); its kernels build with nvcc
        "torch": ["torch>=2.4"],
    },
    classifiers=[
        "License :: OSI Approved :: Apache Software License",
        "Programming Language :: Python :: 3",
        "Topic :: Scientific/Engineering :: Chemistry",
        "Topic :: Scientific/Engineering :: Physics",
    ],
)
