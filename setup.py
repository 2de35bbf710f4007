from setuptools import find_packages, setup

setup(
    name="tpulmi",
    version="0.1.0",
    description=(
        "TPU-native learned index for approximate nearest-neighbor search "
        "(JAX/XLA/Pallas re-design of the SISAP'23 LAION2B LMI submission)"
    ),
    packages=find_packages(include=["tpulmi", "tpulmi.*",
                                    "tpulmi_torch", "tpulmi_torch.*"]),
    # the CUDA sources of tpulmi_torch, compiled with nvcc at first use,
    # and its host library's, compiled with g++
    package_data={"tpulmi_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    extras_require={
        "io": ["h5py"],
        "ckpt": ["orbax-checkpoint"],
        "test": ["pytest"],
    },
)
