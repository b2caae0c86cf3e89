#!/bin/bash
# The runs a cell's bounds are set from: two sets of six untraced runs
# with the same six seeds, then three traced runs, each its own process,
# the spreads printed by portbench.spread.  Run on the card, from the
# root of a checkout:  bash portbench/sets.sh CELL SECONDS DIR
# (e.g. out14 51 runs); outputs go to DIR/CELL/.  SEEDS and TRACED
# (space-separated) replace the default seeds.
cell=$1; secs=$2; dir=$3
d=$dir/$cell; mkdir -p $d
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader
now() { python3 -c 'import time; print(time.time())'; }
go() { local t=$1; shift; local t0=$(now); "$@" > $d/$t.out 2> $d/$t.err; local rc=$?; echo "== $t rc=$rc $(python3 -c "print(round($(now) - $t0, 1))") s"; grep '^portbench:' $d/$t.err; }
SEEDS=${SEEDS:-"2147483693 3221225473 4294967291 5368709131 6442450967 7516192771"}
TRACED=${TRACED:-"8589934583 9663676447 10737418247"}
for set in A B; do
  for s in $SEEDS; do go $set.$s python3 -m portbench.run --workload $cell.solve --seed $s --seconds $secs --trace 0; done
  python3 -m portbench.spread $d/$set.*.out
done
for s in $TRACED; do go T.$s python3 -m portbench.run --workload $cell.solve --seed $s --seconds $secs --trace 1; done
python3 -m portbench.spread $d/T.*.out
