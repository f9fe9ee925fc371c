"""MD ("mismatchingPositions") tag engine — the port's copy of
``adam_tpu/ops/mdtag.py``.

Host-side implementation of the reference's ``util/MdTag.scala``: parse,
regeneration from a (read, reference, cigar) alignment, ``moveAlignment``
after realignment, reference reconstruction ``getReference`` and the
canonical ``toString``.  Equality = (start, canonical string), as in the
reference.

The batch entry point is :func:`batch_md_arrays`, which turns a batch's
MD strings into per-base columns (is-mismatch mask and, on request, the
implied reference base codes) for the BQSR observe pass and realignment.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from adam_tpu_torch.formats import schema

_DIGITS = re.compile(r"[0-9]+")
# Full IUPAC ambiguity alphabet, as the reference's basesPattern accepts
# (util/MdTag.scala digitPattern/basesPattern definitions).
_BASES = re.compile(r"[AGCTNUKMRSWBVHDXY]+")


def parse_cigar(cigar: str) -> list[tuple[int, str]]:
    """'4M2D3M' -> [(4,'M'), (2,'D'), (3,'M')]; '*' -> []."""
    if not cigar or cigar == "*":
        return []
    out = []
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((num, ch))
            num = 0
    return out


@dataclass
class MdTag:
    start: int
    matches: list = field(default_factory=list)  # [(start, end)) ref ranges
    mismatches: dict = field(default_factory=dict)  # ref pos -> ref base
    deletions: dict = field(default_factory=dict)  # ref pos -> ref base

    # ----------------------------------------------------------- constructors
    @staticmethod
    def parse(md: str, reference_start: int) -> "MdTag":
        """Parse an MD string at a given alignment start."""
        tag = MdTag(reference_start)
        if md is None or md == "0" or md == "":
            return tag
        s = md.upper()
        offset = 0
        pos = reference_start

        def read_matches():
            nonlocal offset, pos
            m = _DIGITS.match(s, offset)
            if not m:
                raise ValueError(f"malformed MD tag {md!r} at offset {offset}")
            length = int(m.group())
            if length > 0:
                tag.matches.append((pos, pos + length))
            offset = m.end()
            pos += length

        read_matches()
        while offset < len(s):
            if s[offset] == "^":
                offset += 1
                m = _BASES.match(s, offset)
                if not m:
                    raise ValueError(f"malformed MD deletion in {md!r}")
                for base in m.group():
                    tag.deletions[pos] = base
                    pos += 1
                offset = m.end()
            else:
                m = _BASES.match(s, offset)
                if not m:
                    raise ValueError(f"malformed MD mismatch in {md!r}")
                for base in m.group():
                    tag.mismatches[pos] = base
                    pos += 1
                offset = m.end()
            read_matches()
        return tag

    @staticmethod
    def from_alignment(
        read: str, reference: str, cigar: str, start: int
    ) -> "MdTag":
        """Generate the MD tag of aligning ``read`` against ``reference``
        (reference string starting at the alignment start)."""
        match_count = 0
        del_count = 0
        out = ""
        read_pos = 0
        ref_pos = 0
        for length, op in parse_cigar(cigar):
            if op in "M=X":
                for _ in range(length):
                    if read[read_pos] == reference[ref_pos]:
                        match_count += 1
                    else:
                        out += str(match_count) + reference[ref_pos]
                        match_count = 0
                    read_pos += 1
                    ref_pos += 1
                    del_count = 0
            elif op == "D":
                for _ in range(length):
                    if del_count == 0:
                        out += str(match_count) + "^"
                    out += reference[ref_pos]
                    match_count = 0
                    del_count += 1
                    ref_pos += 1
            elif op in "ISHP":
                if op in "IS":
                    read_pos += length
            else:
                raise ValueError(f"cannot handle CIGAR op {op} in MD generation")
        out += str(match_count)
        return MdTag.parse(out, start)

    @staticmethod
    def move_alignment(
        reference: str,
        sequence: str,
        new_cigar: str,
        read_start: int,
    ) -> "MdTag":
        """Recompute the tag for a new alignment of ``sequence`` against
        ``reference`` (string beginning at ``read_start``)."""
        tag = MdTag(read_start)
        ref_pos = 0
        read_pos = 0
        for length, op in parse_cigar(new_cigar):
            if op == "M":
                rseg = reference[ref_pos : ref_pos + length]
                sseg = sequence[read_pos : read_pos + length]
                if len(rseg) < length or len(sseg) < length:
                    raise IndexError("string index out of range")
                if rseg == sseg:  # whole-segment match, the common case
                    tag.matches.append(
                        (ref_pos + read_start, ref_pos + length + read_start)
                    )
                else:
                    # byte-compare the segment once; match runs are the
                    # gaps between mismatch positions
                    a = np.frombuffer(rseg.encode("ascii"), np.uint8)
                    bb = np.frombuffer(sseg.encode("ascii"), np.uint8)
                    mm = np.flatnonzero(a != bb)
                    for j in mm:
                        tag.mismatches[ref_pos + int(j) + read_start] = rseg[int(j)]
                    prev = -1
                    for j in [int(x) for x in mm] + [length]:
                        if j > prev + 1:
                            tag.matches.append(
                                (ref_pos + prev + 1 + read_start,
                                 ref_pos + j + read_start)
                            )
                        prev = j
                read_pos += length
                ref_pos += length
            elif op == "D":
                dseg = reference[ref_pos : ref_pos + length]
                if len(dseg) < length:
                    raise IndexError("string index out of range")
                for j, ch in enumerate(dseg):
                    tag.deletions[ref_pos + j + read_start] = ch
                ref_pos += length
            elif op in "ISHP":
                if op in "IS":
                    read_pos += length
            else:
                raise ValueError(f"cannot handle CIGAR op {op}")
        return tag

    # --------------------------------------------------------------- queries
    def is_match(self, pos: int) -> bool:
        return any(s <= pos < e for s, e in self.matches)

    def mismatched_base(self, pos: int):
        return self.mismatches.get(pos)

    def deleted_base(self, pos: int):
        return self.deletions.get(pos)

    def end(self) -> int:
        """Largest reference position covered (inclusive)."""
        candidates = [e - 1 for _, e in self.matches]
        candidates += list(self.mismatches)
        candidates += list(self.deletions)
        return max(candidates) if candidates else self.start

    def get_reference(self, read_sequence: str, cigar) -> str:
        """Reconstruct the reference over the aligned span from the read.

        ``cigar`` may be a string or an already-parsed ``[(len, op)]``
        list.  M/=/X segments are emitted as one slice patched at the
        (few) recorded mismatch positions rather than a per-base loop."""
        ref_pos = self.start
        read_pos = 0
        out = []
        elems = parse_cigar(cigar) if isinstance(cigar, str) else cigar
        for length, op in elems:
            if op in "M=X":
                seg = read_sequence[read_pos : read_pos + length]
                if len(seg) < length:
                    # corrupt alignment: the CIGAR span overruns the
                    # read; fail loudly (move_alignment does the same)
                    # instead of emitting a silently truncated reference
                    raise IndexError(
                        f"CIGAR {op}-segment of length {length} overruns "
                        f"read of length {len(read_sequence)} at read "
                        f"position {read_pos}"
                    )
                if self.mismatches:
                    patches = [
                        (p - ref_pos, base)
                        for p, base in self.mismatches.items()
                        if ref_pos <= p < ref_pos + length and base
                    ]
                    if patches:
                        lseg = list(seg)
                        for off, base in patches:
                            lseg[off] = base
                        seg = "".join(lseg)
                out.append(seg)
                read_pos += length
                ref_pos += length
            elif op == "D":
                for _ in range(length):
                    base = self.deletions.get(ref_pos)
                    if base is None:
                        raise ValueError(
                            f"no deleted base recorded at ref pos {ref_pos}"
                        )
                    out.append(base)
                    ref_pos += 1
            elif op in "IS":
                read_pos += length
            elif op in "HP":
                pass
            else:
                raise ValueError(f"cannot handle CIGAR op {op}")
        return "".join(out)

    # ------------------------------------------------------------- emission
    def to_string(self) -> str:
        """Event-walk emission: O(mismatches + deletions), not
        O(span x match-intervals) — positions between events are match
        run length by construction."""
        if not self.matches and not self.mismatches and not self.deletions:
            return "0"
        start, end = self.start, self.end()
        events = sorted(
            [(p, False, b) for p, b in self.mismatches.items()]
            + [(p, True, b) for p, b in self.deletions.items()]
        )
        out = []
        prev_end = start  # next unemitted reference position
        last_was_deletion = False
        for p, is_del, base in events:
            run = p - prev_end
            if is_del:
                if run > 0 or not last_was_deletion:
                    out.append(str(run))
                    out.append("^")
                out.append(base)
                last_was_deletion = True
            else:
                out.append(str(run))
                out.append(base)
                last_was_deletion = False
            prev_end = p + 1
        out.append(str(end + 1 - prev_end))
        return "".join(out)

    __str__ = to_string

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, MdTag)
            and self.start == other.start
            and self.to_string() == other.to_string()
        )



def tokenize_md_column(md_column) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized MD tokenizer over a whole StringColumn of MD tags.

    Returns per-mismatch flat arrays ``(row, ref_off, base_byte)``:
    the batch row of each mismatch, its 0-based reference offset from the
    alignment start, and the reference base (ASCII byte) recorded in the
    MD tag.  Deletion bases (after ``^``) advance the reference offset but
    are not emitted.  Pure numpy — no per-read Python.
    """
    buf = md_column.buf
    offsets = md_column.offsets
    if len(buf) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z.astype(np.uint8)

    is_digit = (buf >= 48) & (buf <= 57)
    is_caret = buf == 94  # '^'
    is_letter = ~is_digit & ~is_caret

    # Only strings containing letters can contribute mismatches; strings
    # that are a plain match count (the common case) are skipped entirely.
    lpos_all = np.flatnonzero(is_letter)
    if len(lpos_all) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z.astype(np.uint8)
    letter_rows = np.unique(
        np.searchsorted(offsets, lpos_all, side="right") - 1
    )
    row_keep = np.zeros(len(offsets) - 1, dtype=bool)
    row_keep[letter_rows] = True

    # ---- number runs (split at string boundaries: tags end with a run) --
    prev_digit = np.zeros(len(buf), dtype=bool)
    prev_digit[1:] = is_digit[:-1]
    run_start = is_digit & ~prev_digit
    starts = offsets[:-1][offsets[:-1] < len(buf)]
    boundary = np.zeros(len(buf), dtype=bool)
    boundary[starts] = True
    run_start |= is_digit & boundary
    # drop bytes of letter-free strings from all token machinery
    byte_keep = np.repeat(row_keep, np.diff(offsets))
    is_digit &= byte_keep
    run_start &= byte_keep

    run_id = np.cumsum(run_start) - 1  # id per byte (valid at digit bytes)
    dpos = np.flatnonzero(is_digit)
    drun = run_id[dpos]
    n_runs = int(run_start.sum())
    run_len = np.bincount(drun, minlength=n_runs)
    run_pos = np.flatnonzero(run_start)  # first byte of each run, in order
    local = dpos - run_pos[drun]
    expo = run_len[drun] - 1 - local
    run_val = np.bincount(
        drun, weights=(buf[dpos] - 48).astype(np.float64) * 10.0 ** expo,
        minlength=n_runs,
    ).astype(np.int64)

    # ---- letters: mismatch vs deletion state ---------------------------
    lpos = np.flatnonzero(is_letter)
    nonletter_idx = np.where(~is_letter, np.arange(len(buf)), -1)
    # force a state reset at string starts so '^' never leaks across tags
    nonletter_idx[starts] = np.maximum(nonletter_idx[starts], starts)
    prev_nonletter = np.maximum.accumulate(nonletter_idx)
    pn = prev_nonletter[lpos]
    is_del = (pn >= 0) & (buf[np.maximum(pn, 0)] == 94)

    # ---- merge tokens in byte order, accumulate reference advance ------
    tok_pos = np.concatenate([run_pos, lpos])
    tok_adv = np.concatenate([run_val, np.ones(len(lpos), np.int64)])
    tok_is_mm = np.concatenate(
        [np.zeros(len(run_pos), bool), ~is_del]
    )
    order = np.argsort(tok_pos, kind="stable")
    tok_pos = tok_pos[order]
    tok_adv = tok_adv[order]
    tok_is_mm = tok_is_mm[order]

    tok_row = np.searchsorted(offsets, tok_pos, side="right") - 1
    csum = np.cumsum(tok_adv)
    ref_off_excl = csum - tok_adv
    # subtract each row's base (exclusive cumsum at its first token)
    n_rows = len(offsets) - 1
    first_tok = np.searchsorted(tok_row, np.arange(n_rows), side="left")
    has_tok = first_tok < len(tok_row)
    base = np.zeros(n_rows, np.int64)
    base[has_tok] = ref_off_excl[np.minimum(first_tok[has_tok], len(tok_row) - 1)]
    ref_off = ref_off_excl - base[tok_row]

    mm = tok_is_mm
    return tok_row[mm], ref_off[mm], buf[tok_pos[mm]]


def batch_md_arrays(
    batch, sidecar, need_ref_codes: bool = True
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-base MD-derived columns for a batch — vectorized.

    Returns (is_mismatch bool[N, L], ref_codes u8[N, L], has_md bool[N]):
    for each *read* position of an aligned base, whether it mismatches the
    reference and the reference base code there (= read base on match, MD
    base on mismatch).  Insertions/soft-clips get ref code BASE_PAD and
    is_mismatch False — the per-residue view BQSR's covariates consume
    (DecadentRead.Residue semantics, rich/DecadentRead.scala:77-116).

    Implementation: one vectorized MD tokenize over the whole column
    (:func:`tokenize_md_column`), then a cumulative-CIGAR coordinate map
    from reference offsets to read positions — no per-read loops.
    ``need_ref_codes=False`` (the observe pass) skips the reference codes
    and returns None in their place.
    """
    from adam_tpu_torch.formats.strings import StringColumn

    b = batch.to_numpy()
    N, L = b.bases.shape
    if N == 0 or b.cigar_ops.shape[1] == 0:
        ref = np.full((N, L), schema.BASE_PAD, np.uint8) if need_ref_codes else None
        return np.zeros((N, L), bool), ref, np.zeros(N, bool)
    md_col = StringColumn.of(sidecar.md)
    valid = np.asarray(b.valid)
    has_md = md_col.valid[:N] & valid if len(md_col) >= N else np.zeros(N, bool)

    ops = np.asarray(b.cigar_ops)
    lens = np.asarray(b.cigar_lens).astype(np.int64)
    C = ops.shape[1]
    q_consume = schema.CIGAR_CONSUMES_QUERY[np.minimum(ops, 15)].astype(np.int64)
    r_consume = schema.CIGAR_CONSUMES_REF[np.minimum(ops, 15)].astype(np.int64)
    read_adv = lens * q_consume
    ref_adv = lens * r_consume
    cum_read_incl = np.cumsum(read_adv, axis=1)
    cum_ref_incl = np.cumsum(ref_adv, axis=1)
    cum_read_excl = cum_read_incl - read_adv
    cum_ref_excl = cum_ref_incl - ref_adv

    both = (q_consume > 0) & (r_consume > 0)
    ref_codes = None
    if need_ref_codes:
        # aligned-position mask per read position (inside M/=/X ops).
        # Fast path: a single M/=/X op spanning the read (the dominant
        # shape) is pos < length; only the remaining rows walk their ops.
        pos = np.arange(L, dtype=np.int64)
        cigar_n = np.asarray(b.cigar_n)
        simple = (cigar_n == 1) & both[:, 0]
        lengths = np.asarray(b.lengths).astype(np.int64)
        aligned = simple[:, None] & (pos[None, :] < lengths[:, None])
        complex_rows = np.flatnonzero(~simple & (cigar_n > 0))
        if len(complex_rows):
            max_ops = int(cigar_n[complex_rows].max())
            for j in range(min(C, max_ops)):
                rows = complex_rows[both[complex_rows, j]]
                if len(rows) == 0:
                    continue
                lo = cum_read_excl[rows, j][:, None]
                hi = (cum_read_excl[rows, j] + read_adv[rows, j])[:, None]
                aligned[rows] |= (pos[None, :] >= lo) & (pos[None, :] < hi)
        ref_codes = np.where(
            aligned & has_md[:, None], np.asarray(b.bases),
            np.uint8(schema.BASE_PAD),
        ).astype(np.uint8)
    is_mm = np.zeros((N, L), dtype=bool)

    rows, ref_off, base_bytes = tokenize_md_column(md_col)
    keep = has_md[rows] if len(rows) else np.zeros(0, bool)
    rows, ref_off, base_bytes = rows[keep], ref_off[keep], base_bytes[keep]
    if len(rows):
        # op containing each mismatch's reference offset
        j = (cum_ref_incl[rows] <= ref_off[:, None]).sum(axis=1)
        j = np.minimum(j, C - 1)
        in_m = both[rows, j]
        read_pos = cum_read_excl[rows, j] + (ref_off - cum_ref_excl[rows, j])
        ok = in_m & (read_pos >= 0) & (read_pos < L)
        r_, p_ = rows[ok], read_pos[ok]
        is_mm[r_, p_] = True
        if ref_codes is not None:
            ref_codes[r_, p_] = schema.BASE_ENCODE_LUT[base_bytes[ok]]
    return is_mm, ref_codes, has_md
