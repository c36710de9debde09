"""How PyTorch's CUDA kernels divide a float32 tensor by a Python number, on
one card: ``x / c`` against candidate forms over 2^20 floats on [-10, 10).

    python3 artifacts/rigid_kernel/scalar_division.py

For each divisor ``c`` (CartPole's total mass 1.1, the landers' and the
classic envs' divisors, episode limits) prints the count of floats where
``x / c`` differs in any bit from: ``x`` times ``1.0f / float32(c)``; ``x``
times ``float32(1 / c)`` (the double reciprocal, which
``ops/lander_kernels.py::card_div`` takes); the double quotient rounded;
``x`` divided by a device tensor holding ``float32(c)``.  Needs one CUDA
GPU; imports nothing of JAX.
"""

import sys

import numpy as np
import torch

DIVISORS = (1.1, 30.0, 50.0, 500, 200, 3.0, 0.7, 1.0 / 3.0, 13.0, 0.1, 1.3, 4.9589)


def main() -> int:
    if not torch.cuda.is_available():
        print("scalar_division: needs a GPU", file=sys.stderr)
        return 1
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.rand(1 << 20, generator=g, device="cuda") - 0.5) * 20
    on_card = lambda v: torch.tensor(v, dtype=torch.float32, device="cuda")  # noqa: E731
    for c in DIVISORS:
        got = x / c
        forms = {
            "x * (1.0f / float32(c))": x * on_card(float(np.float32(1.0) / np.float32(c))),
            "x * float32(1 / c)": x * on_card(float(np.float32(1.0 / c))),
            "float32(double(x) / c)": (x.double() / c).float(),
            "x / float32(c) (a tensor)": x / on_card(float(np.float32(c))),
        }
        print(c, {name: int((v != got).sum()) for name, v in forms.items()})
    print(torch.__version__, torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
