"""Registers, spills and the row loop's instruction count of each of the
port's kernels, read from the built library: the nearest thing to a
profile where `ncu` does not run.

    python -m quaff_tpu_torch.prof.kernel_sass [NAME_PART ...]

builds the kernel library if needed (kernels.library), then prints, for
every kernel whose name contains one of NAME_PART (default: every one),
with the wrapper and route that launch it (kernel_of),

  - registers, stack and local memory a thread (cuobjdump -res-usage), and
    the spill stores and loads that ptxas reported when the build ran in
    this process (-Xptxas -v);
  - its SASS instructions (cuobjdump -sass) and those of its row loop:
    the longest span between a loop's back edge and its target, counted
    statically (an inner loop counts once, whatever its trip count), with
    the local-memory loads and stores (spills) among them and the stall
    cycles ptxas set between them (parse_stalls: a lower bound of the
    loop's cycles for a warp alone on its scheduler).

Needs the CUDA toolkit's cuobjdump (next to nvcc); runs no kernel.
"""

from __future__ import annotations

import pathlib
import re
import shutil
import subprocess
import sys

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
# the line under an instruction that holds only its control word
CONTROL = re.compile(r"^\s*/\* (0x[0-9a-f]{16}) \*/\s*$")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
TARGET = re.compile(r"\bBRA\b(?:\.\w+)*\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
RESOURCE = re.compile(r"Function\s+(\S+):\s*\n\s*REG:(\d+)\s+STACK:(\d+)\s+"
                      r"SHARED:(\d+)\s+LOCAL:(\d+)")
PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_REGS = re.compile(r"Used (\d+) registers")

# The port's kernels by their __global__ function: (part of the demangled
# name, (the wrapper that launches it, its route)), the first match wins.
# K1 and K2 share band_fill_cluster_kernel: its STORE instantiations
# (<false, true, ...>, each mode) are K2's cluster route; the smem
# kernels' instantiations with GLOBAL (their first argument) true are the
# smem routes' global tier.  The probes' chain kernel has one kernel a
# layout of K1's (prof/chains.chain_route), sol_smem_kernel<true, OP> its
# global tier.
KERNEL_NAMES = (
    ("band_fill_cluster_kernel<false, true,", ("fwd_store", "cluster")),
    ("band_fill_warp_kernel<", ("band_fill", "warp")),
    ("band_fill_cluster_kernel<", ("band_fill", "cluster")),
    ("band_fill_smem_kernel<true,", ("band_fill", "global")),
    ("band_fill_smem_kernel<", ("band_fill", "smem")),
    ("fwd_store_warp_kernel<", ("fwd_store", "warp")),
    ("bwd_counts_warp_kernel<", ("bwd_counts", "warp")),
    ("bwd_counts_cluster_kernel<", ("bwd_counts", "cluster")),
    ("fwd_store_smem_kernel<true>", ("fwd_store", "global")),
    ("bwd_counts_smem_kernel<true>", ("bwd_counts", "global")),
    ("fwd_store_smem_kernel", ("fwd_store", "smem")),
    ("bwd_counts_smem_kernel", ("bwd_counts", "smem")),
    ("estep_reduce_kernel", ("estep_reduce", None)),
    ("ov_fill_warp_kernel<", ("ov_fill", "warp")),
    ("ov_fill_cluster_kernel<", ("ov_fill", "cluster")),
    ("sol_warp_kernel<", ("sol_chain", "warp")),
    ("sol_cluster_kernel<", ("sol_chain", "cluster")),
    ("sol_smem_kernel<true,", ("sol_chain", "global")),
    ("sol_smem_kernel<", ("sol_chain", "smem")),
)


def kernel_of(name: str):
    """(wrapper, route) of a kernel by its demangled name, as cuobjdump
    through c++filt or torch.profiler print it (route None for kernels
    with one); None for a kernel that is not the port's."""
    for part, owner in KERNEL_NAMES:
        if part in name:
            return owner
    return None


def parse_sass(text: str) -> dict:
    """{function: [(address, instruction, branch target or None), ...]}
    (cuobjdump prints a branch's target as an address, nvdisasm as a
    label; both are read)."""
    funcs, cur, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = FUNCTION.search(line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            labels[cur] = {}
            pending = []
            continue
        if cur is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            funcs[cur].append((addr, m.group(2)))
    out = {}
    for name, instrs in funcs.items():
        resolved = []
        for addr, ins in instrs:
            t = TARGET.search(ins)
            target = None
            if t:
                target = (labels[name].get(t.group(1)) if t.group(1)
                          else int(t.group(2), 16))
            resolved.append((addr, ins, target))
        out[name] = resolved
    return out


def row_loop(instrs) -> tuple:
    """(instructions, local-memory loads and stores) of the longest loop:
    the most instructions between a predicated backward branch (a loop's
    back edge) and its target, both included ((0, 0) without a loop).  An
    unpredicated backward branch is ignored: ptxas places the slow path of
    a warp shuffle after the kernel's exit and jumps back from it."""
    best = (0, 0)
    for addr, ins, target in instrs:
        if target is not None and target <= addr and ins.startswith("@"):
            body = [ins for a, ins, _ in instrs if target <= a <= addr]
            local = sum(bool(re.search(r"\b(LDL|STL)\b", i)) for i in body)
            best = max(best, (len(body), local))
    return best


def loop_span(instrs):
    """(first, last) address of the longest loop, as row_loop finds it
    (None without a loop)."""
    best, span = 0, None
    for addr, ins, target in instrs:
        if target is not None and target <= addr and ins.startswith("@"):
            n = sum(1 for a, _, _ in instrs if target <= a <= addr)
            if n > best:
                best, span = n, (target, addr)
    return span


def parse_stalls(text: str) -> dict:
    """{function: {address: stall cycles}} from the control word that
    cuobjdump prints under each instruction: bits 41-44 hold the cycles
    ptxas has the warp wait before its next instruction issues.  Their sum
    over a loop is a static lower bound of the loop's cycles for one warp
    alone on its scheduler (waits on variable-latency results, memory and
    MUFU among them, come on top)."""
    out, cur, last = {}, None, None
    for line in text.splitlines():
        m = FUNCTION.search(line)
        if m:
            cur, last = m.group(1), None
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = INSTR.search(line)
        if m:
            last = int(m.group(1), 16)
            continue
        m = CONTROL.match(line)
        if m and last is not None:
            out[cur][last] = (int(m.group(1), 16) >> 41) & 0xF
            last = None
    return out


def parse_resources(text: str) -> dict:
    """{function: (registers, stack, shared, local)} of cuobjdump
    -res-usage."""
    return {m.group(1): tuple(int(m.group(k)) for k in range(2, 6))
            for m in RESOURCE.finditer(text)}


def parse_ptxas(log: str) -> dict:
    """{function: (registers, spill store bytes, spill load bytes)} of an
    nvcc -Xptxas -v log."""
    out, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            cur, spill = m.group(1), (0, 0)
            continue
        m = PTXAS_SPILL.search(line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = PTXAS_REGS.search(line)
        if m and cur:
            out[cur] = (int(m.group(1)), *spill)
            cur = None
    return out


def demangle(names) -> dict:
    """{mangled: readable} through c++filt where the host has it."""
    names = list(names)
    filt = shutil.which("c++filt")
    if not filt or not names:
        return {n: n for n in names}
    res = subprocess.run([filt], input="\n".join(names), text=True,
                         capture_output=True, check=True)
    plain = [re.sub(r"\(anonymous namespace\)::|\(.*$", "", s)
             for s in res.stdout.splitlines()]
    return dict(zip(names, plain))


def _cuobjdump() -> str:
    from .. import kernels

    return str(pathlib.Path(kernels._nvcc()).parent / "cuobjdump")


def report(parts=()) -> list:
    """One dict per kernel of the built library (name, registers, stack,
    local, spill bytes or None, instructions, row-loop instructions)."""
    from .. import kernels

    kernels.library()
    lib = str(kernels.library_path())
    tool = _cuobjdump()
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    res = parse_resources(subprocess.run(
        [tool, "-res-usage", lib], capture_output=True, text=True,
        check=True).stdout)
    ptxas = parse_ptxas(kernels.build_log or "")
    funcs = parse_sass(sass)
    stalls = parse_stalls(sass)
    names = demangle(funcs)
    rows = []
    for mangled, instrs in funcs.items():
        name = names[mangled]
        if parts and not any(p in name for p in parts):
            continue
        reg, stack, _, local = res.get(mangled, (None,) * 4)
        spill = ptxas.get(mangled)
        loop, loop_local = row_loop(instrs)
        span = loop_span(instrs)
        st = stalls.get(mangled, {})
        loop_stalls = 0 if span is None else sum(
            v for a, v in st.items() if span[0] <= a <= span[1])
        rows.append({"name": name, "registers": reg, "stack": stack,
                     "local": local,
                     "spill_bytes": None if spill is None else spill[1:],
                     "instructions": len(instrs), "row_loop": loop,
                     "row_loop_local": loop_local,
                     "row_loop_stalls": loop_stalls})
    return sorted(rows, key=lambda r: r["name"])


def main(argv=None) -> int:
    parts = tuple(sys.argv[1:] if argv is None else argv)
    from .chains import card_label

    card = card_label()
    for r in report(parts):
        spill = ("not rebuilt here" if r["spill_bytes"] is None
                 else f"{r['spill_bytes'][0]}/{r['spill_bytes'][1]} bytes "
                      "spill stores/loads")
        owner = kernel_of(r["name"])
        of = "" if owner is None else f" ({' '.join(filter(None, owner))})"
        print(f"[sass] {r['name']}{of}: {r['registers']} registers, stack "
              f"{r['stack']}, local {r['local']}, {spill}; "
              f"{r['instructions']} instructions, row loop "
              f"{r['row_loop']} ({r['row_loop_local']} local loads and "
              f"stores, {r['row_loop_stalls']} stall cycles) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
