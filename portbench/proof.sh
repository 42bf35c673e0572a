#!/bin/bash
# Proof runs of one cell on the card, each a process of its own as the
# benchmark's check makes them: two sets of <runs> runs (six unless given)
# on the same seeds (--trace 0), then <traced> traced runs (three unless
# given) on further seeds.  Each run's result line is appended to
# $PROOF_OUT/<cell>.jsonl (build/proof unless set), its standard error kept
# beside it.  Not part of a benchmark run.
#   bash portbench/proof.sh <cell> <first seed> [<seconds> [<runs> [<traced>]]]
set -u
cell=$1; seed0=$2; seconds=${3:-51}; runs=${4:-6}; traced=${5:-3}
out=${PROOF_OUT:-build/proof}; mkdir -p "$out"
for set in a b; do
  for ((i = 0; i < runs; i++)); do
    s=$((seed0 + i))
    python3 portbench/run.py --workload "$cell" --seed "$s" --seconds "$seconds" --trace 0 \
      2> "$out/$cell.$set$i.err" | tail -n 1 | sed "s/^/{\"set\": \"$set\", \"seed\": $s, \"line\": /; s/\$/}/" >> "$out/$cell.jsonl"
  done
done
for ((i = runs; i < runs + traced; i++)); do
  s=$((seed0 + i))
  python3 portbench/run.py --workload "$cell" --seed "$s" --seconds "$seconds" --trace 1 \
    2> "$out/$cell.t$i.err" | tail -n 1 | sed "s/^/{\"set\": \"t\", \"seed\": $s, \"line\": /; s/\$/}/" >> "$out/$cell.jsonl"
done
