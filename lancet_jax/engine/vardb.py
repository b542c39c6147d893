"""Variant DB: sha256-keyed dedup across windows/k/shards and VCF dump
(ref: src/VariantDB.{hh,cc})."""

from __future__ import annotations

from ..cpp import sha256_hex
from .variant import Variant


class VariantDB:
    def __init__(self, lr_mode: bool = False):
        self.lr_mode = lr_mode
        self.db: dict[str, Variant] = {}
        self.filters = None
        self.record_sink = None  # optional list capturing add_var inputs
        # (checkpoint logging: replaying captured records through add_var
        # reproduces the DB state — see lancet_jax.checkpoint)

    def __len__(self) -> int:
        return len(self.db)

    def add_var(self, v: Variant) -> None:
        """Keep the record with strictly higher total coverage on signature
        collision (ref: VariantDB.cc:28-91)."""
        if self.record_sink is not None:
            self.record_sink.append(v)
        key = sha256_hex(v.signature())
        old = self.db.get(key)
        if old is None:
            self.db[key] = v
            return
        if old.tot_cov() < v.tot_cov():
            # the reference replaces coverage/HP/BX fields and kmer in place,
            # keeping the original positional fields (identical by signature)
            old.kmer = v.kmer
            old.ref_cov_normal_fwd = v.ref_cov_normal_fwd
            old.ref_cov_normal_rev = v.ref_cov_normal_rev
            old.ref_cov_tumor_fwd = v.ref_cov_tumor_fwd
            old.ref_cov_tumor_rev = v.ref_cov_tumor_rev
            old.alt_cov_normal_fwd = v.alt_cov_normal_fwd
            old.alt_cov_normal_rev = v.alt_cov_normal_rev
            old.alt_cov_tumor_fwd = v.alt_cov_tumor_fwd
            old.alt_cov_tumor_rev = v.alt_cov_tumor_rev
            old.hprn = v.hprn
            old.hprt = v.hprt
            old.hpan = v.hpan
            old.hpat = v.hpat
            if self.lr_mode:
                old.bx_ref_n = v.bx_ref_n
                old.bx_ref_t = v.bx_ref_t
                old.bx_alt_n = v.bx_alt_n
                old.bx_alt_t = v.bx_alt_t

    def merge_from(self, other: "VariantDB") -> None:
        """Merge another shard's DB in its std::map (sha256-lex) key order
        (ref: Lancet.cc:954-958)."""
        for key in sorted(other.db.keys()):
            self.add_var(other.db[key])

    def sorted_variants(self) -> list[Variant]:
        """Position-sorted records; stable sort over sha256-lex key order
        reproduces the reference's std::sort-over-std::map dump
        (VariantDB.cc:161-163 — std::sort is not stable, but byPos is a
        strict weak order on (chr,pos) so equal keys keep ... see note)."""
        items = sorted(self.db.items(), key=lambda kv: kv[0])
        # reference: std::sort with byPos comparator on (chr string, pos).
        # std::sort is unstable; for equal (chr,pos) the relative order is
        # implementation-defined. We use Python's stable sort over the map
        # order, which matches libstdc++ introsort for the small arrays in
        # practice; validated against golden output.
        items.sort(key=lambda kv: (kv[1].chrom, kv[1].pos))
        return [v for _, v in items]

    def vcf_header(self, version: str, reference: str, date: str, fs,
                   sample_n: str, sample_t: str, command_line: str) -> str:
        """(ref: VariantDB.cc:93-151)"""
        from ..cpp import ostream_float

        h = []
        h.append("##fileformat=VCFv4.2\n")
        # reference quirk: no newline between fileDate value and ##source
        h.append(f"##fileDate={date}##source=lancet {version}\n")
        h.append(f"##cmdline={command_line}\n")
        h.append(f"##reference={reference}\n")
        h.append('##INFO=<ID=FETS,Number=1,Type=Float,Description="Phred-scaled p-value of the Fisher\'s exact test for tumor-normal allele counts">\n')
        h.append('##INFO=<ID=SOMATIC,Number=0,Type=Flag,Description="Somatic mutation">\n')
        h.append('##INFO=<ID=SHARED,Number=0,Type=Flag,Description="Shared mutation betweem tumor and normal">\n')
        h.append('##INFO=<ID=NORMAL,Number=0,Type=Flag,Description="Mutation present only in the normal">\n')
        h.append('##INFO=<ID=NONE,Number=0,Type=Flag,Description="Mutation not supported by data">\n')
        h.append('##INFO=<ID=KMERSIZE,Number=1,Type=Integer,Description="K-mer size used to assemble the locus">\n')
        h.append('##INFO=<ID=SB,Number=1,Type=Float,Description="Strand bias score: phred-scaled p-value of the Fisher\'s exact test for the forward/reverse read counts in the tumor">\n')
        h.append('##INFO=<ID=MS,Number=1,Type=String,Description="Microsatellite mutation (format: #LEN#MOTIF)">\n')
        h.append('##INFO=<ID=LEN,Number=1,Type=Integer,Description="Variant size in base pairs">\n')
        h.append('##INFO=<ID=TYPE,Number=1,Type=String,Description="Variant type (snv, del, ins, complex)">\n')
        if self.lr_mode:
            h.append('##INFO=<ID=HPS,Number=1,Type=Float,Description="Haplotype score for the T/N pair: phred-scaled p-value of the Fisher\'s exact test of the total counts of the two haplotype in the tumor-normal pair">\n')
            h.append('##INFO=<ID=HPSN,Number=1,Type=Float,Description="Normal haplotype score: phred-scaled p-value of the Fisher\'s exact test for ref/alt haplotype counts in the normal">\n')
            h.append('##INFO=<ID=HPST,Number=1,Type=Float,Description="Tumor haplotype score: phred-scaled p-value of the Fisher\'s exact test for ref/alt haplotype counts in the tumor">\n')
        h.append(f'##FILTER=<ID=LowCovNormal,Description="Low coverage in the normal (<{fs.min_cov_normal})">\n')
        h.append(f'##FILTER=<ID=HighCovNormal,Description="High coverage in the normal (>{fs.max_cov_normal})">\n')
        h.append(f'##FILTER=<ID=LowCovTumor,Description="Low coverage in the tumor (<{fs.min_cov_tumor})">\n')
        h.append(f'##FILTER=<ID=HighCovTumor,Description="High coverage in the tumor (>{fs.max_cov_tumor})">\n')
        h.append(f'##FILTER=<ID=LowVafTumor,Description="Low variant allele frequency in the tumor (<{ostream_float(fs.min_vaf_tumor)})">\n')
        h.append(f'##FILTER=<ID=HighVafNormal,Description="High variant allele frequency in the normal (>{ostream_float(fs.max_vaf_normal)})">\n')
        h.append(f'##FILTER=<ID=LowAltCntTumor,Description="Low alternative allele count in the tumor (<{fs.min_alt_cnt_tumor})">\n')
        h.append(f'##FILTER=<ID=HighAltCntNormal,Description="High alternative allele count in the normal (>{fs.max_alt_cnt_normal})">\n')
        h.append(f'##FILTER=<ID=LowFisherScore,Description="Low Fisher\'s exact test score for tumor-normal allele counts (<{ostream_float(fs.min_phred_fisher)})">\n')
        h.append(f'##FILTER=<ID=LowFisherSTR,Description="Low Fisher\'s exact test score for tumor-normal STR allele counts (<{ostream_float(fs.min_phred_fisher_str)})">\n')
        h.append(f'##FILTER=<ID=StrandBias,Description="Strand bias: # of non-reference reads in either forward or reverse strand below threshold (<{fs.min_strand_bias})">\n')
        h.append('##FILTER=<ID=STR,Description="Microsatellite mutation">\n')
        if self.lr_mode:
            h.append('##FILTER=<ID=MultiHP,Description="Supporting reads from multiple haplotypes based on linked-reads analysis">\n')
        h.append('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        h.append('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">\n')
        h.append('##FORMAT=<ID=AD,Number=.,Type=Integer,Description="Allele depth: # of supporting ref,alt reads at the site">\n')
        h.append('##FORMAT=<ID=SR,Number=.,Type=Integer,Description="Strand counts for ref: # of supporting forward,reverse reads for reference allele">\n')
        h.append('##FORMAT=<ID=SA,Number=.,Type=Integer,Description="Strand counts for alt: # of supporting forward,reverse reads for alterantive allele">\n')
        if self.lr_mode:
            h.append('##FORMAT=<ID=BX,Number=.,Type=String,Description="Barcodes supporting ref and alt alleles">\n')
            h.append('##FORMAT=<ID=HPR,Number=.,Type=Integer,Description="Haplotype counts for ref: # of reads supporting reference allele in haplotype 1, 2, and 0 respectively (0 = unassigned)">\n')
            h.append('##FORMAT=<ID=HPA,Number=.,Type=Integer,Description="Haplotype counts for alt: # of reads supporting alternative allele in haplotype 1, 2, and 0 respectively (0 = unassigned)">\n')
        h.append(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample_n}\t{sample_t}\n")
        return "".join(h)

    def to_vcf(self, version: str, reference: str, date: str, fs,
               sample_n: str, sample_t: str, command_line: str) -> str:
        out = [self.vcf_header(version, reference, date, fs, sample_n,
                               sample_t, command_line)]
        for v in self.sorted_variants():
            out.append(v.print_vcf(fs))
        return "".join(out)
