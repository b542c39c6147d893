"""Host-side I/O plane: FASTA/fai, BGZF/BAM/BAI, VCF.

Own implementations of the formats (no htslib/bamtools code); the reference
uses htslib faidx for windowed FASTA access and bamtools for BAM region
iteration (SURVEY.md §2.2). Two interchangeable backends per format:
the streaming C++ core (lancet_jax/native, production path) and the
pure-Python readers (fallback / test oracle). `open_bam` / `open_fasta`
pick the backend.
"""

from __future__ import annotations

import os


def _native_ok() -> bool:
    return not os.environ.get("LANCET_NO_NATIVE")


def open_bam(path: str):
    """Indexed BAM reader: native C++ backend when available, else the
    pure-Python one."""
    if _native_ok():
        try:
            from ..native import NativeBamReader

            return NativeBamReader(path)
        except Exception:
            pass
    from .bam import BamReader

    return BamReader(path)


def open_fasta(path: str):
    """faidx-style FASTA: native C++ backend when available."""
    if _native_ok():
        try:
            from ..native import NativeFastaFile

            return NativeFastaFile(path)
        except Exception:
            pass
    from .fasta import FastaFile

    return FastaFile(path)
