"""Install: pip install -e .  (the environment already has all dependencies)."""
from setuptools import find_packages, setup

setup(
    name="dpgo_tpu",
    version="0.1.0",
    description=(
        "TPU-native distributed certifiably-correct pose-graph optimization "
        "(JAX/XLA/Pallas re-design of mit-acl/dpgo)"
    ),
    packages=find_packages(
        include=["dpgo_tpu", "dpgo_tpu.*", "dpgo_tpu_torch", "dpgo_tpu_torch.*"]
    ),
    # the PyTorch/CUDA port builds its kernels from these sources at first use
    package_data={"dpgo_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
)
