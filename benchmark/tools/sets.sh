#!/usr/bin/env bash
# The runs a cell's bounds are set from, on the card, in one call: two sets
# of six runs with the same six seeds, then three traced runs with three
# more; each run's standard output and error in <out dir>.
#   bash benchmark/tools/sets.sh <out dir> <cell> <seconds> <seed base>
O=$1; c=$2; sec=$3; b=$4
mkdir -p "$O"
one() {
  s=$1; tr=$2; tag=$3; t0=$SECONDS
  echo "== $c seed $s trace $tr set $tag"
  python3 benchmark/run.py --workload "$c" --seed "$s" --seconds "$sec" --trace "$tr" \
    > "$O/$c.$tag.$s.$tr.out" 2> "$O/$c.$tag.$s.$tr.err"
  echo "rc=$? wall $((SECONDS - t0)) s"
  tail -1 "$O/$c.$tag.$s.$tr.out" | cut -c1-200
}
for set in A B; do for k in 1 2 3 4 5 6; do one $((b + k)) 0 $set; done; done
for k in 7 8 9; do one $((b + k)) 1 T; done
