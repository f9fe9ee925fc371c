"""MD tag columns — the subset of ``adam_tpu/ops/mdtag.py`` the observe
pass needs: the vectorized MD tokenizer and the per-base mismatch mask
it feeds (:func:`batch_md_arrays`)."""

from __future__ import annotations

import numpy as np

from adam_tpu_torch.formats import schema


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


def batch_md_arrays(batch, sidecar) -> tuple[np.ndarray, np.ndarray]:
    """Per-base MD-derived columns of a host batch -> (is_mismatch
    bool[N, L], has_md bool[N]): for each read position of an aligned
    base, whether it mismatches the reference.  Insertions and soft
    clips are never mismatches.  One vectorized MD tokenize over the
    whole column, then a cumulative-CIGAR map from reference offsets to
    read positions (``adam_tpu.ops.mdtag.batch_md_arrays`` with
    ``need_ref_codes=False``)."""
    from adam_tpu_torch.formats.strings import StringColumn

    b = batch.to_numpy()
    N, L = b.bases.shape
    if N == 0 or b.cigar_ops.shape[1] == 0:
        return np.zeros((N, L), bool), np.zeros(N, bool)
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
    cum_read_excl = np.cumsum(read_adv, axis=1) - read_adv
    cum_ref_incl = np.cumsum(ref_adv, axis=1)
    cum_ref_excl = cum_ref_incl - ref_adv
    both = (q_consume > 0) & (r_consume > 0)
    is_mm = np.zeros((N, L), dtype=bool)

    rows, ref_off, _base_bytes = tokenize_md_column(md_col)
    keep = has_md[rows] if len(rows) else np.zeros(0, bool)
    rows, ref_off = rows[keep], ref_off[keep]
    if len(rows):
        # op containing each mismatch's reference offset
        j = (cum_ref_incl[rows] <= ref_off[:, None]).sum(axis=1)
        j = np.minimum(j, C - 1)
        in_m = both[rows, j]
        read_pos = cum_read_excl[rows, j] + (ref_off - cum_ref_excl[rows, j])
        ok = in_m & (read_pos >= 0) & (read_pos < L)
        is_mm[rows[ok], read_pos[ok]] = True
    return is_mm, has_md
