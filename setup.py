"""Install: pip install -e ."""
import os

from setuptools import find_packages, setup

here = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(here, "README.md")) as f:
    long_description = f.read()

setup(
    name="mlqem-tpu",
    version="0.1.0",
    description="TPU-native machine-learning quantum error mitigation "
                "(JAX/XLA rebuild of qiskit-community/ml-qem)",
    long_description=long_description,
    long_description_content_type="text/markdown",
    packages=find_packages(exclude=["tests", "tests.*"]),
    package_data={
        "mlqem_tpu.device": ["fixtures/*.json"],
        "mlqem_tpu.apps": ["fixtures/*.txt"],
        "mlqem_tpu_torch": ["csrc/*.cu"],
    },
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
    ],
    extras_require={
        "dev": ["pytest", "scipy"],
    },
)
