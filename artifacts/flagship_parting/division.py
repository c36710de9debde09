"""On a CUDA GPU: PyTorch's division of a float32 tensor by a Python float
(a CPU scalar, done as a multiply by its float32 reciprocal) against the
division by the same value in a device tensor (a true division), at Adam's
bias corrections and at exploration rates, and whether an ε-greedy action
(``floor(4·u/ε)``) ever differs."""
import torch
g = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn((1 << 20,), generator=g, device="cuda")
u = torch.rand((1 << 20,), generator=g, device="cuda")
for bc in (0.1, 0.0019980, 0.9481521, 0.7712, 1 / 3):
    f = float(torch.tensor(bc, dtype=torch.float32))
    t = torch.tensor(f, device="cuda")
    a, b = x / f, x / t
    print(f"x / {f!r}: {int((a != b).sum())} of {x.numel()} differ; max rel "
          f"{float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()):.3g}")
for eps in (0.9, 0.459, 0.01, 1 / 3):
    e32 = float(torch.tensor(eps, dtype=torch.float32))
    t = torch.tensor(e32, device="cuda")
    a = torch.clamp((u / e32 * 4).to(torch.int32), max=3)
    b = torch.clamp((u / t * 4).to(torch.int32), max=3)
    q = u / e32 != u / t
    print(f"u / eps at eps {e32!r}: quotients differ in {int(q.sum())}, actions in "
          f"{int(((a != b) & (u < t)).sum())} of {int((u < t).sum())} explored draws")
