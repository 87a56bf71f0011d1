"""System and accelerator report (port of ``utils/sysinfo.py``).

The reference's ``get_sys_information`` (src/utils.py:527-613, behind
``--sys_info``): the host (platform, Python, CPUs, memory from
``/proc/meminfo``), torch's and CUDA's versions and the devices. On a
card it adds each GPU's name and power limit, as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them, and
its memory from ``torch.cuda``.
"""

from __future__ import annotations

import os
import platform
import shutil
import subprocess
from pathlib import Path

__all__ = ["get_sys_information", "format_sys_information"]


def _meminfo() -> dict:
    out = {}
    p = Path("/proc/meminfo")
    if p.exists():
        for line in p.read_text().splitlines():
            k, _, v = line.partition(":")
            if k in ("MemTotal", "MemAvailable"):
                out[k] = v.strip()
    return out


def _nvidia_smi() -> list[str]:
    """``name, power.limit`` per GPU, or [] where nvidia-smi is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    try:
        out = subprocess.run([exe, "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()] \
        if out.returncode == 0 else []


def get_sys_information() -> dict:
    info = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "cpu_count": os.cpu_count(),
        "memory": _meminfo(),
    }
    import torch
    info["torch_version"] = torch.__version__
    info["cuda_version"] = torch.version.cuda
    info["cuda_available"] = torch.cuda.is_available()
    devices = ["cpu"]
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            devices.append(f"cuda:{i} {p.name} ({p.total_memory / 2**30:.1f} "
                           f"GiB, {p.multi_processor_count} SMs, sm_"
                           f"{p.major}{p.minor})")
        info["gpus"] = _nvidia_smi()
    info["devices"] = devices
    import numpy
    info["numpy_version"] = numpy.__version__
    return info


def format_sys_information() -> str:
    info = get_sys_information()
    lines = ["System information:"]
    for k, v in info.items():
        lines.append(f"  {k}: {v}")
    return "\n".join(lines)
