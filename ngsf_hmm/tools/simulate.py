"""IBD-tract data simulator (equivalent of scripts/ngsF-HMMsim.R).

Simulates, per individual: a true IBD path from the same transition model
the engine fits (reference: ngsF-HMMsim.R:14-36), haplotypes with
IBD-copying (:238-247), genotypes, and Poisson-depth binomial-error
genotype likelihoods (:48-67). Writes the same five files with the same
layouts: .ind.txt, .path.gz, .geno.gz, .glf.gz, .pos.gz.

RNG: seeded NumPy Generator -- same distributions as the R script but not
draw-for-draw identical to R's Mersenne sampler (documented deviation; the
golden test suite feeds the SAME simulated files to both binaries, so
cross-engine comparisons are unaffected).
"""

import gzip
import sys

import numpy as np

AVG_DIST = 1e5  # mean distance between sampled SNPs (ngsF-HMMsim.R:181)


def _binom_pmf(k, n, p):
    """dbinom without scipy: exact via log-gamma."""
    from math import lgamma

    k = np.asarray(k, dtype=np.int64)
    n = np.asarray(n, dtype=np.int64)
    p = np.asarray(p, dtype=np.float64)
    lg = np.vectorize(lgamma)
    with np.errstate(divide="ignore", invalid="ignore"):
        logc = lg(n + 1) - lg(k + 1) - lg(n - k + 1)
        lp = np.where(k > 0, k * np.log(p), 0.0)
        lq = np.where(n - k > 0, (n - k) * np.log1p(-p), 0.0)
    out = np.exp(logc + lp + lq)
    # dbinom(0, 0, p) == 1
    return np.where((n == 0) & (k == 0), 1.0, out)


def sim_transition(state, dist_mb, indF, alpha, rng):
    """One step of the true IBD chain (ngsF-HMMsim.R:23-36)."""
    x = np.exp(-alpha * dist_mb)
    p01 = (1 - x) * indF
    p10 = (1 - x) * (1 - indF)
    if state == 0:
        return int(rng.random() < p01)
    return int(rng.random() >= p10)


def simulate(
    n_ind=10,
    n_sites=1000,
    freq="0.2",
    site_pos="r",
    indF="0.5",
    alpha="0.01",
    depth="2",
    error=0.01,
    seed=12345,
    out="sim",
    n_chr=1,
    missing=0.0,
):
    """n_chr: split the sites evenly over this many chromosomes
    (chrSIM1..chrSIMk in .pos.gz; positions restart per chromosome and
    the true IBD chain re-draws its state from the stationary
    distribution at each chromosome start -- the reference reads such a
    .pos as an INFINITY inter-site distance, read_data.cpp:195-210,
    which collapses the transition to the stationary q, HMM.cpp:132-136).
    n_chr == 1 keeps the legacy single 'chrSIM' naming byte-for-byte.

    missing: probability that an (individual, site) cell has zero reads
    -- its GLs become the uniform triplet, exactly the missing-data rows
    of real ANGSD Beagle output (gen_func.cpp:862-868 is the consumer)."""
    rng = np.random.default_rng(seed)

    def per_ind(spec, n):
        if spec == "r":
            return rng.uniform(size=n)
        try:
            return np.full(n, float(spec))
        except ValueError:
            return np.loadtxt(spec, ndmin=1)[:n]

    indF_v = per_ind(indF, n_ind)
    alpha_v = per_ind(alpha, n_ind)
    if depth == "r":
        depth_v = rng.uniform(size=n_ind) * 4 + 1
    else:
        depth_v = per_ind(depth, n_ind)
    freq_v = per_ind(freq, n_sites)

    if site_pos == "r":
        pos_dist = rng.normal(AVG_DIST, AVG_DIST / 3, size=n_sites).astype(np.int64)
        pos_dist[pos_dist < 1] = 1
    else:
        pos_dist = np.full(n_sites, int(float(site_pos)), dtype=np.int64)
    dist_mb = pos_dist / 1e6
    # chromosome id per site (even split); chr_start marks each
    # chromosome's first site, where the chain re-draws stationarily
    chr_id = (np.arange(n_sites) * int(n_chr)) // n_sites
    chr_start = np.zeros(n_sites, bool)
    chr_start[0] = True
    chr_start[1:] = chr_id[1:] != chr_id[:-1]

    # true IBD paths
    path = np.zeros((n_ind, n_sites), dtype=np.int8)
    for i in range(n_ind):
        st = int(rng.random() < indF_v[i])
        path[i, 0] = st
        for s in range(1, n_sites):
            if chr_start[s]:
                # new chromosome: infinite distance -> stationary draw
                st = int(rng.random() < indF_v[i])
            else:
                st = sim_transition(
                    st, dist_mb[s], indF_v[i], alpha_v[i], rng
                )
            path[i, s] = st

    # haplotypes with IBD copying -> genotypes
    geno = np.zeros((n_ind, n_sites), dtype=np.int8)
    for i in range(n_ind):
        hap1 = (rng.random(n_sites) < freq_v).astype(np.int8)
        hap2 = (rng.random(n_sites) < freq_v).astype(np.int8)
        ibd = path[i] == 1
        hap1[ibd] = hap2[ibd]
        geno[i] = hap1 + hap2

    # genotype likelihoods (getLikes, ngsF-HMMsim.R:48-67)
    p_by_geno = np.array([error, 0.5, 1 - error])
    gl = np.zeros((n_ind, n_sites, 3))
    true_depth = np.zeros((n_ind, n_sites), dtype=np.int64)
    for i in range(n_ind):
        d = rng.poisson(depth_v[i], size=n_sites)
        if missing > 0.0:
            # zero-read cells: GLs normalise to the uniform triplet
            d[rng.random(n_sites) < missing] = 0
        true_depth[i] = d
        nA = rng.binomial(d, p_by_geno[geno[i]])
        for g in range(3):
            gl[i, :, g] = _binom_pmf(nA, d, p_by_geno[g])
        gl[i] /= gl[i].sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        log_gl = np.round(np.log(gl), 10)

    # ---- outputs
    np.savetxt(
        out + ".ind.txt",
        np.column_stack([depth_v, indF_v, alpha_v]),
        fmt="%s",
        delimiter="\t",
    )
    with gzip.open(out + ".path.gz", "wt") as fh:
        for i in range(n_ind):
            fh.write("".join(str(int(x)) for x in path[i]) + "\n")
    with gzip.open(out + ".geno.gz", "wt") as fh:
        for s in range(n_sites):
            fh.write("\t".join(str(int(geno[i, s])) for i in range(n_ind)) + "\n")
    with gzip.open(out + ".glf.gz", "wt") as fh:
        for s in range(n_sites):
            # R writeLines(..., sep="\t") leaves a trailing tab per line
            vals = []
            for i in range(n_ind):
                vals.extend(_r_chr(log_gl[i, s, g]) for g in range(3))
            fh.write("\t".join(vals) + "\t\n")
    # positions restart at each chromosome start
    pos = np.empty(n_sites, np.int64)
    run = 0
    for s in range(n_sites):
        run = pos_dist[s] if chr_start[s] else run + pos_dist[s]
        pos[s] = run
    with gzip.open(out + ".pos.gz", "wt") as fh:
        for s in range(n_sites):
            chrom = "chrSIM" if int(n_chr) == 1 else f"chrSIM{chr_id[s] + 1}"
            depths = ",".join(str(int(true_depth[i, s])) for i in range(n_ind))
            fh.write(
                f"{chrom}\t{pos[s]}\t{_r_chr(freq_v[s])}\t"
                f"{int(true_depth[:, s].sum())}\t{depths}\n"
            )
    return {
        "path": path,
        "geno": geno,
        "gl": log_gl,
        "pos": pos,
        "indF": indF_v,
        "alpha": alpha_v,
    }


def simulate_binary(n_ind, n_sites, out, freq=0.2, indF=0.5, alpha=0.01,
                    depth=2.0, error=0.01, seed=12345):
    """The same generative model as simulate(), vectorised over cells,
    for cohorts too large for its per-site text writers (100 x 1M and
    up). Writes out.glf (raw little-endian doubles [S][N][3] of linear
    GLs: the reference's binary input, read with --geno out.glf and no
    --loglkl) and out.pos.gz (chromosome and position columns).
    Returns the true IBD path [N, S] (int8).

    The IBD chain is sampled in its renewal form: at each site the
    state is kept with probability exp(-alpha * d), else redrawn from
    Bernoulli(F) -- the same transition as sim_transition. The GL
    binomial coefficient is common to the three genotypes, so it
    cancels in the normalisation and is not computed."""
    rng = np.random.default_rng(seed)
    S, N = int(n_sites), int(n_ind)
    pos_dist = rng.normal(AVG_DIST, AVG_DIST / 3, size=S).astype(np.int64)
    pos_dist[pos_dist < 1] = 1
    d = (pos_dist / 1e6)[None, :]
    Fv = np.full((N, 1), float(indF))
    redraw = rng.random((N, S)) >= np.exp(-float(alpha) * d)
    redraw[:, 0] = True
    draw = rng.random((N, S)) < Fv
    last = np.maximum.accumulate(
        np.where(redraw, np.arange(S)[None, :], 0), axis=1)
    path = np.take_along_axis(draw, last, axis=1).astype(np.int8)
    del redraw, draw, last

    hap1 = rng.random((N, S)) < freq
    hap2 = rng.random((N, S)) < freq
    geno = np.where(path == 1, 2 * hap2, hap1.astype(np.int8) + hap2)
    del hap1, hap2
    p_by_geno = np.array([error, 0.5, 1 - error])
    reads = rng.poisson(float(depth), size=(N, S))
    alt = rng.binomial(reads, p_by_geno[geno])
    del geno
    lgl = np.empty((S, N, 3))
    for g in range(3):
        lgl[..., g] = (alt * np.log(p_by_geno[g])
                       + (reads - alt) * np.log1p(-p_by_geno[g])).T
    del reads, alt
    lgl -= lgl.max(axis=-1, keepdims=True)
    np.exp(lgl, out=lgl)
    lgl /= lgl.sum(axis=-1, keepdims=True)
    lgl.astype("<f8").tofile(out + ".glf")
    del lgl
    pos = np.cumsum(pos_dist)
    with gzip.open(out + ".pos.gz", "wt", compresslevel=1) as fh:
        fh.write("".join(f"chrSIM\t{p}\n" for p in pos.tolist()))
    return path


def synth_device(n_sites, n_ind, seed, depth=2.0, error=0.01):
    """Seeded GLs made on the default device, for benchmarks and smoke
    runs too large to stage through host files: Poisson(depth) reads,
    uniform true genotypes, error-rate binomial allele counts (normal
    approximation). Returns (gl [S, N, 3] normalised log f32, dist [S]
    Mb f32 between adjacent sites)."""
    import jax
    import jax.numpy as jnp

    S, N = int(n_sites), int(n_ind)

    @jax.jit
    def make(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        dt = jnp.float32
        reads = jax.random.poisson(k1, depth, (S, N)).astype(dt)
        truth = jax.random.randint(k2, (S, N), 0, 3)
        p = jnp.array([error, 0.5, 1 - error], dt)
        pt = p[truth]
        sd = jnp.sqrt(jnp.maximum(reads * pt * (1 - pt), 1e-6))
        alt = jnp.clip(jnp.round(reads * pt + sd * jax.random.normal(
            k3, (S, N))), 0.0, reads)[..., None]
        ll = alt * jnp.log(p) + (reads[..., None] - alt) * jnp.log1p(-p)
        gl = ll - jax.scipy.special.logsumexp(ll, axis=-1, keepdims=True)
        step_bp = jax.random.randint(k4, (S,), 100, 200_000).astype(dt)
        return gl, step_bp / 1e6

    return make(jax.random.key(seed))


def _r_chr(x):
    """R as.character-style shortest float representation."""
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return np.format_float_positional(x, precision=15, trim="-")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-n", "--n_ind", type=int, default=10)
    ap.add_argument("-s", "--n_sites", type=int, default=1000)
    ap.add_argument("-f", "--freq", default="0.1")
    ap.add_argument("-x", "--site_pos", default="1")
    ap.add_argument("-F", "--indF", default="0")
    ap.add_argument("-a", "--alpha", default="0.01")
    ap.add_argument("-d", "--depth", default="5")
    ap.add_argument("-e", "--error", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("-o", "--out", default="sim")
    ap.add_argument("--n_chr", type=int, default=1)
    ap.add_argument("--missing", type=float, default=0.0)
    a = ap.parse_args(argv)
    simulate(
        n_ind=a.n_ind, n_sites=a.n_sites, freq=a.freq, site_pos=a.site_pos,
        indF=a.indF, alpha=a.alpha, depth=a.depth, error=a.error,
        seed=a.seed, out=a.out, n_chr=a.n_chr, missing=a.missing,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
