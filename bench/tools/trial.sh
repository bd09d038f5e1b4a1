# Short trial runs of the cells on the card, for bring-up of the harness:
#   bash bench/tools/trial.sh <out dir> <cell>:<seed>:<seconds>:<trace> ...
set -u
out=$1; shift
mkdir -p "$out"
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for spec in "$@"; do
  IFS=: read -r w s sec t <<<"$spec"
  f=$out/$w.$s.t$t
  t0=$SECONDS
  python3 bench/run.py --workload "$w" --seed "$s" --seconds "$sec" --trace "$t" >"$f.out" 2>"$f.err"
  echo "$w seed $s trace $t rc=$? wall $((SECONDS - t0)) s"
  tail -n 8 "$f.err"; tail -c 2500 "$f.out"; echo
done
