from setuptools import find_packages, setup

setup(
    name="deepspeed_tpu",
    version="0.1.0",
    description="TPU-native training & inference framework (DeepSpeed capability set on JAX/XLA/Pallas)",
    packages=find_packages(include=["deepspeed_tpu", "deepspeed_tpu.*",
                                    "deepspeed_tpu_torch", "deepspeed_tpu_torch.*"]),
    # the port's CUDA sources, compiled by nvcc at first use
    package_data={"deepspeed_tpu_torch": ["ops/csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "pydantic"],
    # the PyTorch/CUDA port (deepspeed_tpu_torch) needs torch, not jax
    extras_require={"torch": ["torch", "numpy"]},
    entry_points={"console_scripts": [
        "dstpu=deepspeed_tpu.launcher.runner:main",
        "dstpu_report=deepspeed_tpu.env_report:cli_main",
    ]},
)
