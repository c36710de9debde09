# Where the seed-0 lunar_jointed_per runs of the port at 0b5fbe4 and of this
# tree part, on one CUDA GPU, from the root of a checkout:
#   git archive 0b5fbe4 deep_q_learning_tpu_torch | tar -x -C build/pr14   (mkdir -p first)
#   bash artifacts/flagship_parting/run.sh
set -e
out=build/part
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee $out/card.txt
python3 artifacts/flagship_parting/division.py | tee $out/division.txt
env PYTHONPATH=build/pr14 python3 artifacts/flagship_parting/part.py pr14 $out/pr14.json
env PYTHONPATH=. python3 artifacts/flagship_parting/part.py eager $out/eager.json
env PYTHONPATH=. python3 artifacts/flagship_parting/part.py graphed $out/graphed.json
env PYTHONPATH=. python3 artifacts/flagship_parting/part.py eager_float_bc $out/eager_float_bc.json
