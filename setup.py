from setuptools import find_packages, setup

setup(
    name="refil-tpu",
    version="0.1.0",
    description="TPU-native multi-agent RL framework (REFIL/PyMARL capabilities, JAX/XLA/Pallas)",
    packages=find_packages(include=["refil_tpu", "refil_tpu.*", "refil_torch", "refil_torch.*"]),
    package_data={
        "refil_tpu": ["config/*.yaml", "config/algs/*.yaml", "config/envs/*.yaml"],
        # the PyTorch/CUDA port: its YAML copies and the CUDA sources nvcc builds
        "refil_torch": ["config/*.yaml", "config/algs/*.yaml", "config/envs/*.yaml",
                        "csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "PyYAML"],
    extras_require={"test": ["pytest", "chex"]},
)
