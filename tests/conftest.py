"""Test config: run JAX on a virtual 8-device CPU mesh with float64 on.

Multi-chip hardware is not available in CI; sharding tests use
xla_force_host_platform_device_count=8 per the project test strategy.
Must run before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")
# the CLI points JAX at a persistent compile cache in the checkout
# (utils/compile_cache.py); in-process CLI tests keep it off
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import jax  # noqa: E402

# pin the platform through the config too, in case the environment
# selected another before python started
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_SRC = pathlib.Path("/root/reference")
REF_BUILD = REPO / "tests" / ".refbin"


@pytest.fixture(scope="session")
def reference_binary():
    """Build the reference C++ binary (oracle for golden tests).

    Uses a minimal GSL-taus shim header since GSL is not installed. Skips
    golden tests when the reference sources or a compiler are unavailable.
    """
    exe = REF_BUILD / "ngsF-HMM"
    if exe.exists():
        return exe
    if not REF_SRC.exists():
        pytest.skip("reference sources not available")
    REF_BUILD.mkdir(parents=True, exist_ok=True)
    shim = REPO / "tests" / "gsl_shim"
    cpp = [
        "shared/gen_func.cpp",
        "shared/read_data.cpp",
        "shared/HMM.cpp",
        "shared/bfgs.cpp",
        "parse_args.cpp",
        "EM.cpp",
        "ngsF-HMM.cpp",
        "shared/threadpool.c",
    ]
    try:
        subprocess.run(
            ["g++", "-O2", "-w", f"-I{shim}", f"-I{REF_SRC}/shared",
             "-D_FILE_OFFSET_BITS=64", "-D_LARGEFILE64_SOURCE"]
            + [str(REF_SRC / f) for f in cpp]
            + ["-lz", "-lpthread", "-o", str(exe)],
            check=True, capture_output=True, cwd=REF_BUILD,
        )
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        pytest.skip(f"cannot build reference binary: {e}")
    return exe
