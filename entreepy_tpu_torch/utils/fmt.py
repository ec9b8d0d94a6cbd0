"""Human-readable size formatting for the CLI summary line.

Mirrors the reference's humanizer (``utils.zig:3-13``): bytes print as-is,
KB/MB/GB with two decimals, 1024 steps.
"""

from __future__ import annotations


def format_file_size(byte_count: float) -> str:
    if byte_count < 1024:
        n = int(byte_count)
        return f"{n} B" if n == byte_count else f"{byte_count} B"
    if byte_count < 1024**2:
        return f"{byte_count / 1024:.2f} KB"
    if byte_count < 1024**3:
        return f"{byte_count / 1024**2:.2f} MB"
    return f"{byte_count / 1024**3:.2f} GB"
