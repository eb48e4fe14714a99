#!/usr/bin/env python3
"""Count the SASS instructions of the port's CUDA kernels, loop by loop.

    python3 tools/sass_count.py [--root DIR] [--label NAME]

Builds ``stark_anatomy_tpu_torch``'s kernel libraries (csrc/field.cu and
csrc/merkle.cu) from DIR (default: this checkout) as the package itself
does, disassembles them with ``cuobjdump -sass``, and prints one JSON line
for the kernels named in KERNELS:

* ``registers``: the registers a thread uses (``cuobjdump -res-usage``);
* ``instructions``: the kernel's SASS instructions (NOPs left out), and
  ``opcodes``: every opcode with its count, most frequent first;
* ``loops``: each backward branch and the instructions from its target to
  it (the loop body as laid out, inner loops included), with the counts
  of the multiply opcodes (``IMAD.WIDE.U32`` and ``IMAD.HI.U32`` are one
  32x32->64 word product each), ``SHFL`` and ``BRA``;
* ``chains`` for each loop: the loop's instructions split into
  independent data-flow chains (registers renamed on each write; a value
  that enters the loop joins nothing), the sizes of the largest, and
  ``runs``, the number of maximal runs of consecutive instructions from
  one of the two largest chains.  Two chains laid out one after the other
  give a handful of runs; two chains the scheduler interleaves give
  hundreds.

Each kernel's full disassembly goes to
``chiprun_out/sass/LABEL/<kernel>.sass``.  It needs ``nvcc`` and
``cuobjdump``, so it runs where the card is; it launches nothing.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

KERNELS = ("pow_kernel", "rescue_kernel", "binary_kernel", "ntt_kernel", "merkle_kernel",
           "seed_expand_kernel")
NO_DEST = ("ST", "BRA", "EXIT", "BAR", "NOP", "BSSY", "BSYNC", "WARPSYNC", "RET", "CALL",
           "JMP", "YIELD", "MEMBAR", "RED", "DEPBAR", "ERRBAR", "CCTL", "BPT")
INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
FUNC = re.compile(r"Function\s*:\s*(\S+)")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
REG = re.compile(r"\b(U?R\d+|U?P\d)\b")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "cuobjdump")


def parse(sass: str) -> dict:
    """{function name: [(address, guard, opcode, operands)]}, and the
    label addresses of each function under the key (name, 'labels')."""
    funcs, name, pending = {}, None, []
    for line in sass.splitlines():
        m = FUNC.search(line)
        if m:
            name = m.group(1)
            funcs[name], funcs[(name, "labels")] = [], {}
            continue
        if name is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.match(line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2)
        for label in pending:
            funcs[(name, "labels")][label] = addr
        pending = []
        guard = ""
        if text.startswith("@"):
            guard, text = text.split(None, 1)
        op, _, rest = text.partition(" ")
        operands = [o.strip() for o in rest.split(",")] if rest.strip() else []
        if op != "NOP":
            funcs[name].append((addr, guard, op, operands))
    return funcs


def branch_target(operands, labels):
    if not operands:
        return None
    target = operands[0].strip("`() ")
    if target.startswith("0x"):
        return int(target, 16)
    return labels.get(target)


def regs(operand: str, wide: bool):
    """Register names an operand reads or writes; a 64-bit operand (R4.64,
    or the pair of a wide multiply) names both registers of its pair."""
    out = []
    for r in REG.findall(operand):
        if r in ("RZ", "PT", "URZ", "UPT"):
            continue
        out.append(r)
        if (wide or ".64" in operand) and r[0] in "RU" and r[-1].isdigit():
            base = "UR" if r.startswith("UR") else "R"
            out.append(f"{base}{int(r[len(base):]) + 1}")
    return out


def dests_and_sources(guard, op, operands):
    if not operands or op.startswith(NO_DEST):
        return [], [r for o in operands for r in regs(o, False)] + regs(guard, False)
    wide = ".WIDE" in op or op.endswith(".64")
    n_dest = 1
    if op.startswith("SHFL"):
        n_dest = 2                     # the predicate, then the value
    while n_dest < len(operands) and re.fullmatch(r"!?(U?P\d|U?PT)", operands[n_dest]):
        n_dest += 1                    # carry-out and compare predicates
    dests = [r for o in operands[:n_dest] for r in regs(o, wide and o is operands[0])]
    last = len(operands) - 1
    sources = [r for i, o in enumerate(operands[n_dest:], n_dest)
               for r in regs(o, wide and i == last and not op.startswith("IMAD.HI"))]
    return dests, sources + regs(guard, False)


def chains(body):
    """(sizes of the data-flow chains, largest first; runs of the two
    largest) for a loop body [(addr, guard, op, operands)]."""
    parent = list(range(len(body)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    writer = {}                # register -> the instruction that last wrote it
    for i, (_, guard, op, operands) in enumerate(body):
        dests, sources = dests_and_sources(guard, op, operands)
        for r in sources:
            if writer.get(r) is not None:
                parent[find(i)] = find(writer[r])
        for r in dests:
            # a constant (no register read) joins nothing, like a value
            # from before the loop: both chains may read one zero register
            writer[r] = i if sources else None
    groups = collections.Counter(find(i) for i in range(len(body)))
    ranked = [g for g, _ in groups.most_common()]
    top = set(ranked[:2])
    seq = [find(i) for i in range(len(body)) if find(i) in top]
    runs = sum(1 for k, g in enumerate(seq) if k == 0 or g != seq[k - 1])
    return [groups[g] for g in ranked[:6]], runs


def loops(instrs, labels):
    out = []
    for addr, guard, op, operands in instrs:
        if not op.startswith("BRA"):
            continue
        target = branch_target(operands, labels)
        if target is None or target >= addr:      # forward, or the trap after EXIT
            continue
        body = [ins for ins in instrs if target <= ins[0] <= addr]
        ops = collections.Counter(ins[2] for ins in body)
        sizes, runs = chains(body)
        out.append({
            "from": hex(target), "to": hex(addr), "instructions": len(body),
            "wide_products": ops["IMAD.WIDE.U32"] + ops["IMAD.HI.U32"],
            "imad": sum(c for o, c in ops.items() if o.startswith("IMAD")),
            "iadd3": sum(c for o, c in ops.items() if o.startswith("IADD3")),
            "shfl": sum(c for o, c in ops.items() if o.startswith("SHFL")),
            "bra": sum(c for o, c in ops.items() if o.startswith("BRA")),
            "chains": sizes, "runs": runs,
        })
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from stark_anatomy_tpu_torch.field import kernels as K

    libs = K.build()
    sass, usage = "", ""
    for lib in libs.values():
        sass += subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                               check=True).stdout
        usage += subprocess.run([cuobjdump(), "-res-usage", lib], capture_output=True, text=True,
                                check=True).stdout
    registers = dict(re.findall(r"Function (\S+):\s*REG:(\d+)", usage))
    funcs = parse(sass)
    out_dir = os.path.join("chiprun_out", "sass", args.label)
    os.makedirs(out_dir, exist_ok=True)
    report = {}
    for name, instrs in funcs.items():
        if isinstance(name, tuple):
            continue
        kernel = next((k for k in KERNELS if k in name), None)
        if kernel is None:
            continue
        if kernel == "binary_kernel":
            kernel += "<" + re.search(r"MontMul|AddMod|SubMod", name).group(0) + ">"
        inv = re.search(r"pow_kernelI.*Lb(\d)E+v", name)
        if inv:
            kernel += "<inverse chain>" if inv.group(1) == "1" else "<ladder>"
        template = re.search(r"ntt_kernelILi(\d+)ELb(\d)E", name)
        if template:
            kernel += f"<{template.group(1)}, {'true' if template.group(2) == '1' else 'false'}>"
        report[kernel] = {"registers": int(registers.get(name, -1)), "instructions": len(instrs),
                          "opcodes": dict(collections.Counter(i[2] for i in instrs).most_common()),
                          "loops": loops(instrs, funcs[(name, "labels")])}
        with open(os.path.join(out_dir, re.sub(r"[<>]", "_", kernel) + ".sass"), "w") as f:
            f.write(f"// Function : {name}\n")
            for addr, guard, op, operands in instrs:
                f.write(f"/*{addr:04x}*/ {guard + ' ' if guard else ''}{op} {', '.join(operands)} ;\n")
    print(json.dumps({"label": args.label, "root": root,
                      "libraries": [os.path.basename(lib) for lib in libs.values()],
                      "kernels": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
