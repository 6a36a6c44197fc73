"""Cross-platform physical-memory probe.

Mirrors the reference's getMemorySize (src/memsize.cpp): Windows via
GlobalMemoryStatusEx, macOS/BSD via sysctl (hw.memsize / hw.physmem),
POSIX via sysconf(_SC_PHYS_PAGES * _SC_PAGE_SIZE), 0 when unknown.
"""

from __future__ import annotations

import os
import sys


def get_memory_size() -> int:
    """Physical RAM in bytes, or 0 if it cannot be determined."""
    if sys.platform.startswith("win"):
        try:
            import ctypes

            class MEMORYSTATUSEX(ctypes.Structure):
                _fields_ = [
                    ("dwLength", ctypes.c_uint32),
                    ("dwMemoryLoad", ctypes.c_uint32),
                    ("ullTotalPhys", ctypes.c_uint64),
                    ("ullAvailPhys", ctypes.c_uint64),
                    ("ullTotalPageFile", ctypes.c_uint64),
                    ("ullAvailPageFile", ctypes.c_uint64),
                    ("ullTotalVirtual", ctypes.c_uint64),
                    ("ullAvailVirtual", ctypes.c_uint64),
                    ("ullAvailExtendedVirtual", ctypes.c_uint64),
                ]

            stat = MEMORYSTATUSEX()
            stat.dwLength = ctypes.sizeof(MEMORYSTATUSEX)
            if ctypes.windll.kernel32.GlobalMemoryStatusEx(ctypes.byref(stat)):
                return int(stat.ullTotalPhys)
        except Exception:
            pass
        return 0

    # macOS / BSD: sysctl hw.memsize (64-bit) or hw.physmem
    if sys.platform == "darwin" or "bsd" in sys.platform:
        for key in ("hw.memsize", "hw.physmem64", "hw.physmem"):
            try:
                import subprocess

                out = subprocess.run(
                    ["sysctl", "-n", key], capture_output=True, text=True
                )
                if out.returncode == 0 and out.stdout.strip():
                    return int(out.stdout.strip())
            except Exception:
                continue

    # POSIX sysconf path (Linux, Solaris, AIX, also works on macOS)
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
        if pages > 0 and page_size > 0:
            return pages * page_size
    except (ValueError, OSError, AttributeError):
        pass

    # last resort: /proc/meminfo
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0
