"""Where two seed-0 ``lunar_jointed_per`` runs part: a digest of the online
weights' bits after every update (eager learners: each ``Optimizer.apply``)
and after every superstep, through SUPERSTEPS supersteps, written to OUT.

    env PYTHONPATH=<checkout of the port> python3 part.py MODE OUT

MODE: ``pr14`` (a checkout of 0b5fbe4, whose trainer has only the eager
learner), ``eager`` and ``graphed`` (this tree's eager and graphed
learners), ``eager_float_bc`` (this tree's eager learner with Adam's bias
corrections as Python floats, as 0b5fbe4 divided by them)."""
import json, sys, torch
mode, out = sys.argv[1], sys.argv[2]
SUPERSTEPS = 6
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from deep_q_learning_tpu_torch.algos import dqn
from deep_q_learning_tpu_torch.config import lunar_jointed_per
from deep_q_learning_tpu_torch.train import Trainer

digests = []
def digest(params):
    return int(sum(p.detach().view(torch.int32).to(torch.int64).sum() for p in params).item())
apply = dqn.Optimizer.apply
def recording(self, grads, state, params, *a, **k):
    apply(self, grads, state, params, *a, **k)
    digests.append(digest(params))
if mode in ("pr14", "eager", "eager_float_bc"):
    dqn.Optimizer.apply = recording
if mode == "eager_float_bc":  # the bias corrections as Python floats, as 0b5fbe4 divided by them
    dqn._device_bias_correction = lambda d, c: dqn._bias_correction(d, int(c))
kw = {} if mode == "pr14" else dict(graphed_learner=(mode == "graphed"))
tr = Trainer(lunar_jointed_per(), device="cuda", **kw).init(seed=0)
per = []
for i in range(SUPERSTEPS):
    m = tr.step()
    per.append([m.loss_sum, m.window_mean, m.episodes, digest(tr.runner.train.online.parameters())])
json.dump({"updates": digests, "supersteps": per}, open(out, "w"))
print(mode, len(digests), per[-1], flush=True)
