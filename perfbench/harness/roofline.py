"""The least time the card could take over a kernel's work, from the
bytes the data needs: each input byte read once, each output byte
written once, counted from the generated reads, never from the
program's padding or grid.  The peak is the H100 SXM data sheet's."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, 80 GB HBM3
N_QUAL, N_DINUC = 94, 17


def observe_hist_bytes(inp, observed_residues: int) -> float:
    """Kernel 1 over one job: the i32 covariate key of each observed
    residue, the residue and mismatch bits of every residue of the reads,
    and one merged pair of i32 histograms written.  ``inp`` is the
    seed's input (:class:`perfbench.drivers.transform_cli.Input`)."""
    bins = (inp.n_rg + 1) * N_QUAL * (2 * inp.read_len + 1) * N_DINUC
    return 4.0 * observed_residues + 2.0 * inp.residues / 8.0 + 2 * 4.0 * bins


def pack_rows_bytes(inp) -> float:
    """Kernel 2 over one job: every read's qualities and bases read from
    their rows and written packed, one byte each way."""
    return 4.0 * float(inp.residues)


def share(bytes_needed: float, device_s: float) -> float | None:
    """Percent of the roofline, or None where the kernel never ran."""
    if device_s <= 0:
        return None
    return 100.0 * bytes_needed / HBM_BYTES_PER_S / device_s
