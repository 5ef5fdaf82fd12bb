"""ngsf_hmm -- accelerator inbreeding-tract (IBD) engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of fgvieira/ngsF-HMM:
a two-state HMM over per-site genotype likelihoods, trained by EM
(forward-backward E-step; M-steps for per-individual inbreeding F and
transition rate alpha, and per-site minor allele frequency), decoded with
Viterbi, emitting .indF / .ibd / .geno outputs.

Layout:
  ops/      elementwise numerical kernels (logsum, HWE, transitions, ...)
  models/   HMM scans, bounded L-BFGS, the EM engine
  parallel/ device-mesh sharding (individuals data-parallel, psum freq)
  io/       readers/writers with byte parity, GSL RNG parity
  tools/    simulator, plotting, IBD format conversion
"""

from .utils.constants import VERSION as __version__
