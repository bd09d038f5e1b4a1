# Two sets of six runs of a cell with the same seeds, then three traced runs:
#   bash bench/tools/sets.sh <out dir> <cell> <seconds> <s1,...,s6> <t1,t2,t3>
set -u
out=$1; w=$2; sec=$3; seeds=$4; tseeds=$5
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for set in 1 2; do
  for s in ${seeds//,/ }; do
    f=$out/$w.set$set.$s; t0=$SECONDS
    python3 bench/run.py --workload "$w" --seed "$s" --seconds "$sec" --trace 0 >"$f.out" 2>"$f.err"
    echo "$w set $set seed $s rc=$? wall $((SECONDS - t0)) s: $(tail -n 1 "$f.out" | cut -c1-220)"
  done
done
for s in ${tseeds//,/ }; do
  f=$out/$w.trace.$s; t0=$SECONDS
  python3 bench/run.py --workload "$w" --seed "$s" --seconds "$sec" --trace 1 >"$f.out" 2>"$f.err"
  echo "$w trace seed $s rc=$? wall $((SECONDS - t0)) s"
done
