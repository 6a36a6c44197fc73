"""Inputs of a cell, made from --seed: references, read sets, and the files
the train command reads.

The read simulator is a frozen copy of chip_smoke.py's `_workload`
(chip_smoke.py:827-870 at the commit that added this benchmark): each
position of a read is substituted, followed by an inserted base, or deleted
with probabilities split[0]*err, split[1]*err and split[2]*err; every other
read is reverse complemented; qualities are drawn from the quality values
of the repository's nanopore read c8f30 (hmmbench/data/c8f30.qual, copied
from tests/data/c8f30.fastq.gz), which quaff's default model fits.  Added
here: amplicon reads with a fixed count of reads a target (only their
order, copies and errors depend on the seed, so every seed does the same
work), and a panel of species on a tree, each with its copies.
"""

from __future__ import annotations

import pathlib

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def qualities() -> np.ndarray:
    q = (DATA / "c8f30.qual").read_text().strip()
    return np.frombuffer(q.encode(), np.uint8).astype(np.int64) - 33


def _mutate(rng, t, subs: int) -> np.ndarray:
    """t with `subs` substitutions at distinct positions."""
    t = t.copy()
    pos = rng.choice(len(t), subs, replace=False)
    t[pos] = (t[pos] + rng.integers(1, 4, subs)) % 4
    return t


def references(cfg: dict, seed: int):
    """[(name, tokens)] of the configuration's references.

    A genome is one seeded sequence.  A panel is a tree: each clade and
    species mutates from its parent (the ancestor, at the panel's
    max_length, for a parent of null) at its own substitution rate, so two
    species lie about the sum of the rates on the path between them apart;
    each species is cut to its length and carries `copies` references, the
    species' sequence and copies-1 others with copy_substitutions
    substitutions each (the rrn operons of one genome)."""
    refs = cfg["references"]
    rng = _rng(seed, 1)
    if refs["kind"] == "genome":
        return [(refs["name"], rng.integers(0, 4, refs["length"]))]
    if refs["kind"] != "panel":
        raise ValueError(f"unknown reference kind {refs['kind']}")
    node = {None: rng.integers(0, 4, refs["max_length"])}
    for n in refs["clades"] + refs["species"]:
        t = node[n["parent"]].copy()
        hit = rng.random(len(t)) < n["substitution"]
        t[hit] = (t[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        node[n["name"]] = t
    out = []
    for sp in refs["species"]:
        root = node[sp["name"]][:sp["length"]]
        for c in range(sp["copies"]):
            copy = root if c == 0 else _mutate(rng, root,
                                               refs["copy_substitutions"])
            out.append((f"{sp['name']}_c{c}", copy))
    return out


def targets(cfg: dict):
    """[(share, [reference indices])]: what amplicon reads are drawn from,
    a genome's one sequence or each species' copies with its share."""
    refs = cfg["references"]
    if refs["kind"] == "genome":
        return [(1.0, [0])]
    out, k = [], 0
    for sp in refs["species"]:
        out.append((sp["share"], list(range(k, k + sp["copies"]))))
        k += sp["copies"]
    return out


def apportion(shares, n: int):
    """n reads split by shares, largest remainders first: the same counts
    for every seed."""
    w = np.asarray(shares, np.float64)
    exact = n * w / w.sum()
    counts = np.floor(exact).astype(int)
    for k in np.argsort(-(exact - counts), kind="stable")[:n - counts.sum()]:
        counts[k] += 1
    return counts.tolist()


def _simulate(rng, t, model, quals, reverse: bool):
    err = model["error"]
    s_sub, s_ins, _ = model["split"]
    n = len(t)
    t = t.copy()
    r = rng.random(n)
    sub = r < s_sub * err
    t[sub] = (t[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    ins = (r >= s_sub * err) & (r < (s_sub + s_ins) * err)
    dele = (r >= (s_sub + s_ins) * err) & (r < err)
    pos = np.nonzero(ins)[0] + 1
    t = np.insert(t, pos, rng.integers(0, 4, len(pos)))
    keep = np.ones(len(t), bool)
    keep[np.nonzero(dele)[0] + np.searchsorted(pos, np.nonzero(dele)[0],
                                               side="right")] = False
    t = t[keep]
    if reverse:
        t = (3 - t)[::-1]
    return t, rng.choice(quals, len(t))


def read_sets(cfg: dict, traffic: dict, refs, seed: int):
    """traffic["sets"] read sets of traffic["reads_per_set"] reads each:
    [[(tokens, quals)]].  Amplicon reads are the configuration's amplicon (each reference less
    amplicon.trim5 and amplicon.trim3 bases) of a seeded copy of a target,
    each target's reads counted by its share.  Only the order of the
    lengths and targets, the copies and the errors depend on the seed, so
    every seed does the same work.  Every other read is reverse
    complemented."""
    quals = qualities()
    model = cfg["read_model"]
    spec = traffic["reads"]
    n = traffic["reads_per_set"]
    out = []
    for k in range(traffic["sets"]):
        rng = _rng(seed, 2, k)
        reads = []
        if spec["kind"] == "amplicon":
            tg = targets(cfg)
            counts = apportion([s for s, _ in tg], n)
            picks = np.repeat(np.arange(len(tg)), counts)
            a5, a3 = cfg["amplicon"]["trim5"], cfg["amplicon"]["trim3"]
            for i, g in enumerate(rng.permutation(picks)):
                copies = tg[g][1]
                t = refs[copies[int(rng.integers(0, len(copies)))]][1]
                reads.append(_simulate(rng, t[a5:len(t) - a3], model, quals,
                                       bool(i % 2)))
        else:
            raise ValueError(f"unknown read kind {spec['kind']}")
        out.append(reads)
    return out


def _seq(tok) -> str:
    return ACGT[np.asarray(tok)].tobytes().decode()


def write_fasta(path, refs) -> None:
    pathlib.Path(path).write_text(
        "".join(f">{name}\n{_seq(t)}\n" for name, t in refs))


def write_fastq(path, reads) -> None:
    pathlib.Path(path).write_text("".join(
        f"@read{i}\n{_seq(t)}\n+\n"
        f"{(np.asarray(q) + 33).astype(np.uint8).tobytes().decode()}\n"
        for i, (t, q) in enumerate(reads)))
