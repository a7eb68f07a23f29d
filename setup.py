from setuptools import find_packages, setup

setup(
    name="blvm_tpu",
    version="0.1.0",
    description="TPU-native benchmarking of generative latent variable models for speech (JAX/XLA/Pallas), "
    "with a PyTorch/CUDA port for NVIDIA Hopper (blvm_tpu_torch)",
    packages=find_packages(include=["blvm_tpu", "blvm_tpu.*", "blvm_tpu_torch", "blvm_tpu_torch.*"]),
    package_data={
        "blvm_tpu.native": ["*.cpp"],  # built on demand with g++ at first use
        "blvm_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],  # built on demand with nvcc at first use
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
    ],
    extras_require={
        "dev": ["pytest"],
        "wandb": ["wandb"],
        "torch": ["torch"],
    },
)
