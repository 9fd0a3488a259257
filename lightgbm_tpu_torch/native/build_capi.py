"""Build the C ABI library (``capi.cpp``) of lightgbm_tpu_torch.

Port of ``lightgbm_tpu/native/build_capi.py``: one g++ line links the
source against the running interpreter's libpython (sysconfig), and the
library is content-hashed into ``lightgbm_tpu_torch/_build/`` as
``liblightgbm_tpu_torch_<hash>.so``, a name of its own beside the
reference package's library. ``build_capi()`` returns its path, or None
with a warning when the build fails.

    python -m lightgbm_tpu_torch.native.build_capi
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sysconfig
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "capi.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")


def build_capi() -> Optional[str]:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"liblightgbm_tpu_torch_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    inc = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    # "libpython3.12.so" -> "python3.12"
    pylib = sysconfig.get_config_var("LDLIBRARY") or ""
    if pylib.startswith("lib"):
        pylib = pylib[3:]
    for suf in (".so", ".a", ".dylib"):
        if pylib.endswith(suf):
            pylib = pylib[: -len(suf)]
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{inc}", _SRC,
           "-o", tmp, f"-L{libdir}", f"-l{pylib}", f"-Wl,-rpath,{libdir}"]
    from .. import log
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        os.replace(tmp, so_path)
        return so_path
    except subprocess.CalledProcessError as e:
        log.warning("C ABI build FAILED:\n"
                    + e.stderr.decode("utf-8", "replace"))
        return None
    except Exception as e:
        log.warning(f"C ABI build FAILED: {e}")
        return None
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


if __name__ == "__main__":
    print(build_capi() or "BUILD FAILED")
