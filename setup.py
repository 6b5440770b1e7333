from setuptools import setup, find_packages

setup(
    name="waterorderlib-tpu",
    version="0.1.0",
    packages=find_packages(include=[
        "waterorderlib_tpu", "waterorderlib_tpu.*",
        "waterorderlib_tpu_torch", "waterorderlib_tpu_torch.*",
    ]),
    # the port's CUDA sources are compiled by nvcc at first use
    package_data={"waterorderlib_tpu_torch.ops.cuda": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
)
