"""C++ programs of the port, built at first use.

``build(source)`` compiles one C++ file with g++ (C++17, -O2, -pthread)
against the repository's ``cpp/`` headers (``ray_tpu_client.hpp``,
``ray_tpu_worker.hpp``, unchanged) into ``build/cpp/`` beside the package
(``.gitignore`` lists ``build/``), keyed by the hash of the source and the
headers, and returns the binary's path. A failed build raises
RuntimeError with g++'s output: there is no fallback.

    from ray_tpu_torch import cpp
    driver = cpp.build(cpp.HERE / "generate_driver.cpp")
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
HEADERS = REPO / "cpp"
BUILD_DIR = REPO / "build" / "cpp"


def build(source) -> str:
    """The binary of ``source`` (a .cpp path), compiled once per content."""
    source = Path(source)
    h = hashlib.sha256(source.read_bytes())
    for hdr in sorted(HEADERS.glob("*.hpp")):
        h.update(hdr.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}"
    if not out.exists():
        tmp = f"{out}.{os.getpid()}.tmp"
        p = subprocess.run(["g++", "-std=c++17", "-O2", "-pthread", f"-I{HEADERS}", str(source), "-o", tmp],
                           capture_output=True, text=True, timeout=300)
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed on {source} (exit {p.returncode}):\n{p.stderr}")
        os.replace(tmp, out)
    return str(out)
