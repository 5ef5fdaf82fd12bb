#!/usr/bin/env bash
# End-to-end demo mirroring the reference's examples/test.sh simulated
# half (simulate -> infer across configurations -> convert -> plot).
# Run from the repo root:  bash examples/demo.sh [outdir]
set -euo pipefail
OUT=${1:-ngsf-hmm-demo}
# DEVICE=cpu runs the f64 reference-compatible path (fast at demo scale);
# DEVICE=gpu + KERNEL=pallas is the f32 speed path for large cohorts.
DEVICE=${DEVICE:-cpu}
KERNEL=${KERNEL:-scan}
mkdir -p "$OUT"; cd "$OUT"
N_IND=10; N_SITES=10000; SEED=12345

echo "== simulate (ngsF-HMMsim.R equivalent)"
python -m ngsf_hmm.tools.simulate --n_ind $N_IND --n_sites $N_SITES \
    --freq 0.2 --indF 0.5 --alpha 0.01 --depth 2 --error 0.01 \
    --seed $SEED --out sim

COMMON="--pos sim.pos.gz --n_ind $N_IND --n_sites $N_SITES --seed $SEED --verbose 1 --device $DEVICE --kernel $KERNEL"
echo "== infer: TRUE (params fixed at simulated truth)"
python -m ngsf_hmm --geno sim.glf.gz --loglkl $COMMON \
    --freq 0.2 --freq_est 0 --indF 0.5,0.01 --indF_fixed --out demo.TRUE
echo "== infer: normal (cold start) on genotype likelihoods"
python -m ngsf_hmm --geno sim.glf.gz --loglkl $COMMON \
    --freq 0.1 --indF 0.1,0.2 --out demo.normal
echo "== infer: called genotypes"
python -m ngsf_hmm --geno sim.geno.gz $COMMON \
    --freq 0.1 --indF 0.1,0.2 --out demo.TG
echo "== infer: multi-restart (ngsF-HMM.sh protocol)"
python -m ngsf_hmm --geno sim.glf.gz --loglkl $COMMON \
    --freq r --indF r --n_rep 5 --out demo.multi

echo "== convert Viterbi tracts to BED"
gunzip -kf sim.pos.gz
seq 0 $((N_IND-1)) | sed 's/^/ind_/' > sim.ind
python -m ngsf_hmm.tools.convert_ibd --ind sim.ind --pos sim.pos \
    --ibd_pos demo.normal.ibd > demo.normal.bed
echo "== plot tracts vs simulated truth"
python -m ngsf_hmm.tools.plot_ibd -i demo.normal.ibd -n $N_IND \
    -s $N_SITES --pos sim.pos --marg_prob --path sim.path.gz \
    -o demo.normal.pdf

echo; echo "Outputs in $OUT:"
ls -la demo.* | awk '{print "  " $NF, "(" $5 "b)"}'
echo "estimated F per individual (demo.normal.indF):"
sed -n "2,$((N_IND+1))p" demo.normal.indF
