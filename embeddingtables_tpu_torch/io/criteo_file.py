"""Write a Criteo-Kaggle-format `train.txt` from the synthetic generator, so
the file pipeline (native parser, prefetch, the copy to the card) can run
where the real dataset is not at hand: the port's copy of
`scripts/make_criteo_file.py`, which writes the same bytes for the same
`--rows`, `--vocab` and `--seed`.

Row format: label, I1..I13, C1..C26, tab-separated, one row a line, the
format `data.criteo_kaggle_batches` and `native/criteo_parser.cpp` read.
The categorical tokens are chosen so that FNV-1a(token) % vocab is the row
id the generator drew: a token bank holds one 8-hex-digit token per row id.

    python -m embeddingtables_tpu_torch.io.criteo_file out.txt \
        --rows 500000 --vocab 50000
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import CRITEO_NUM_SPARSE, SyntheticCriteo


def token_bank(vocab: int, seed: int) -> np.ndarray:
    """For each row id r in [0, vocab): a hex token with FNV-1a(token) %
    vocab == r, found by scanning random candidates (about vocab * ln(vocab)
    of them)."""
    def fnv1a_vec(arr: np.ndarray) -> np.ndarray:
        # FNV-1a over fixed-width 8-character ASCII tokens.
        h = np.full(arr.shape[0], 0xCBF29CE484222325, np.uint64)
        for k in range(arr.shape[1]):
            h = (h ^ arr[:, k].astype(np.uint64)) * np.uint64(0x100000001B3)
        return h

    bank = np.zeros(vocab, dtype="S8")
    have = np.zeros(vocab, bool)
    rng = np.random.default_rng(seed)
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    need = vocab
    while need:
        cand = hexd[rng.integers(0, 16, (max(65536, 4 * need), 8))]
        ids = (fnv1a_vec(cand) % np.uint64(vocab)).astype(np.int64)
        # The first candidate of each id still missing wins.
        order = np.argsort(ids, kind="stable")
        ids_s = ids[order]
        first = np.ones(len(ids_s), bool)
        first[1:] = ids_s[1:] != ids_s[:-1]
        sel = order[first]
        sel_ids = ids[sel]
        fresh = ~have[sel_ids]
        bank[sel_ids[fresh]] = [cand[s].tobytes() for s in sel[fresh]]
        have[sel_ids[fresh]] = True
        need = int((~have).sum())
    return bank


def batch_lines(batch: dict, bank: np.ndarray, rows: int) -> bytes:
    """The first `rows` examples of a `SyntheticCriteo` batch as Criteo
    lines: the label and the dense counts (`expm1` of the log1p features,
    truncated) as decimal integers, the ids as their bank tokens."""
    ints = np.concatenate(
        [batch["label"][:rows, None].astype(np.int64),
         np.expm1(batch["dense"][:rows]).astype(np.int64)], axis=1)
    cols = [c.tolist() for c in ints.astype(str).T]
    cols += [bank[batch["cat"][t, :rows]].astype("U8").tolist()
             for t in range(CRITEO_NUM_SPARSE)]
    return "".join("\t".join(r) + "\n" for r in zip(*cols)).encode()


def write_criteo_file(path: str, rows: int, vocab: int, seed: int = 0) -> int:
    """Write `rows` rows over 26 tables of `vocab` ids to `path`; returns the
    bytes written."""
    gen = SyntheticCriteo(vocab_sizes=tuple([vocab] * CRITEO_NUM_SPARSE),
                          batch_size=8192, seed=seed)
    bank = token_bank(vocab, seed ^ 0xBEEF)
    written = 0
    with open(path, "wb") as f:
        for batch in gen.batches():
            if written >= rows:
                break
            n = min(rows - written, batch["label"].shape[0])
            f.write(batch_lines(batch, bank, n))
            written += n
    return os.path.getsize(path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--vocab", type=int, default=50_000)
    ap.add_argument("--tables", type=int, default=CRITEO_NUM_SPARSE)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.tables != CRITEO_NUM_SPARSE:
        ap.error("the Criteo format has 26 categorical fields")
    size = write_criteo_file(args.out, args.rows, args.vocab, args.seed)
    print(f"wrote {args.rows} rows to {args.out} ({size / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
