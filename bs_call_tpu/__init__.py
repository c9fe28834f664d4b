"""bs_call_tpu — bisulfite variant + methylation calling engine.

A from-scratch JAX/XLA framework with the capabilities of
heathsc/bs_call v2.1.7: reads coordinate-sorted SAM/BAM of bisulfite-converted
reads plus a FASTA reference (and optional dbSNP index) and emits VCF/BCF
records with genotype calls, genotype likelihoods, strand-resolved
methylation-informative base counts, CpG context annotations and a JSON stats
report — with the genotype model evaluated in large batches, on the host
(native C++ float64) or on an NVIDIA GPU (the fused device tier).
"""

__version__ = "0.1.0"
