import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py

exec(open("mustache_tpu/_version.py").read())


class BuildWithNative(build_py):
    """Build the native ingest library (io/native) at install time.

    Failure is non-fatal: the pure-Python decoders are a complete
    fallback, so environments without a toolchain still install.
    """

    def run(self):
        try:
            subprocess.run(["make", "-C", "mustache_tpu/io/native"],
                           check=True, timeout=300)
        except Exception as e:  # pragma: no cover - toolchain-dependent
            print(f"warning: native ingest library not built ({e}); "
                  "pure-Python decoders will be used")
        super().run()

setup(
    name="mustache-tpu",
    version=__version__,  # noqa: F821
    description=(
        "Multi-scale chromatin loop detection for Hi-C and Micro-C "
        "contact maps on the GPU (scale-space DoG method, JAX/XLA)"
    ),
    packages=find_packages(exclude=["tests"]),
    cmdclass={"build_py": BuildWithNative},
    package_data={"mustache_tpu.io.native": ["*.so", "*.cpp", "Makefile"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    # .cool/.mcool input reads HDF5 through h5py, imported on first use
    extras_require={"cool": ["h5py"]},
    entry_points={
        "console_scripts": [
            "mustache-tpu = mustache_tpu.cli:main",
            "diff-mustache-tpu = mustache_tpu.diff_cli:main",
        ]
    },
)
