"""Where the MobileResnet's bf16 serving artifact leaves gcc_tpu's, and the
floor of that gap.

tests/test_torch_serve_export.py holds the port's bf16 resnet artifact
against gcc_tpu's at rms(port - jax_bf16) / rms(jax_bf16 - jax_fp32) and
finds 0.381, past the 1/4 of the other generators; the first module apart
is ``down_0`` (3x3 stride 2, 3 -> 6), one bf16 ulp in 0.022 % of its
outputs. Here, on the same inputs:

* The port's ``down_0`` output is the correctly rounded one at every
  output: the exact sum of its bf16 products (float64), rounded to fp32 and
  then to bf16 before the bias, as the conv rounds; an fp32 sum in the
  taps' order or reversed gives the same bits (a second valid fp32 order
  moves nothing: at 27 taps the fp32 sums are exact). gcc_tpu's differs
  from it at the outputs where the two frameworks differ: the departure is
  gcc_tpu's (XLA's conv), not a rounding point the port misses.
* With gcc_tpu's ``down_0`` output put in its place, the port's forward
  meets gcc_tpu's artifact within the 1/4: the whole gap is that one ulp.
* The floor: the port's own output with ``down_0`` moved by one ulp at as
  many outputs, at seeded random places, against the port's: one such move
  alone carries the ratio past the 1/4 (0.33-0.42 where it is not
  absorbed), and the gap is of its size. Every number is printed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

import test_torch_serve_export as tse  # noqa: E402

from gcc_tpu_torch.ops.layers import add_bias  # noqa: E402
from gcc_tpu_torch.utils import serve_export as sx  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401

BF = torch.bfloat16
N_PLACES = 8  # seeded random placements of the one-ulp moves


def _finish(conv, y):
    """A conv's fp32 sum rounded to bf16, then its bias as the conv adds
    it."""
    return add_bias(y.float().to(BF), conv.bias)


def _forward(net, x, down_0=None):
    """The bf16 net's output on x, with ``down_0``'s output replaced by
    ``down_0`` (NCHW bf16) when given, and down_0's input."""
    seen = []

    def hook(_m, inputs, out):
        seen.append(inputs[0])
        return out if down_0 is None else down_0

    h = net.down_0.register_forward_hook(hook)
    try:
        y = net(torch.from_numpy(x).to(BF))[0]
    finally:
        h.remove()
    return y.float().numpy(), seen[0]


def _one_ulp(y, n, seed):
    """y (bf16) with n outputs at seeded random places moved by one ulp."""
    flat = y.float().flatten().clone()
    rng = np.random.RandomState(seed)
    for i in rng.choice(flat.numel(), n, replace=False):
        v = float(flat[i])
        ulp = 2.0 ** (np.floor(np.log2(max(abs(v), 2.0 ** -126))) - 7)
        flat[i] = v + (ulp if rng.rand() < 0.5 else -ulp)
    return flat.reshape(y.shape).to(BF)


@torch.no_grad()
def test_resnet_bf16_gap_is_gcc_tpus_rounding_of_down_0(tmp_path):
    port, state, _, _ = tse.case("resnet")
    x, _ = tse.inputs("resnet", 3)
    mod, _, _ = tse.port_artifact("resnet", "bfloat16", None, str(tmp_path))
    y_port = tse.run_port(mod, x, "bfloat16")
    net = sx.portable(state.nets["g"]).eval().to(BF)
    eager, xin = _forward(net, x)
    np.testing.assert_array_equal(eager, y_port)

    (name, _, got, want), _ = tse.first_difference("resnet")
    assert name == "down_0"
    conv = net.down_0
    y64 = F.conv2d(xin.double(), conv.weight.to(BF).double(), None,
                   conv.stride, conv.padding)
    exact = _finish(conv, y64).float().numpy()
    cols = F.unfold(xin.float(), conv.weight.shape[2:],
                    padding=conv.padding, stride=conv.stride)
    taps = (conv.weight.to(BF).float().reshape(conv.weight.shape[0], -1)
            [None, :, :, None] * cols[:, None])
    shape = (x.shape[0],) + got.shape[1:]
    for order in (range(taps.shape[2]), reversed(range(taps.shape[2]))):
        acc = torch.zeros_like(taps[:, :, 0])
        for k in order:
            acc = acc + taps[:, :, k]
        np.testing.assert_array_equal(
            _finish(conv, acc.reshape(shape)).float().numpy(), exact)
    np.testing.assert_array_equal(got, exact)  # the port: correctly rounded
    apart = got != want
    share = float(np.mean(apart))
    assert 0.0 < share <= 0.01
    assert tse.bf16_ulps(got, want) <= 1.0
    np.testing.assert_array_equal(want[~apart], exact[~apart])

    jb = tse.jax_output("resnet", "bfloat16")
    spread = tse.rms(jb - tse.jax_output("resnet", "float32"))
    gap = tse.rms(y_port - jb) / spread
    with_jax, _ = _forward(net, x, torch.from_numpy(want).to(BF))
    closed = tse.rms(with_jax - jb) / spread
    floors = []
    for seed in range(N_PLACES):
        moved, _ = _forward(net, x, _one_ulp(torch.from_numpy(got).to(BF),
                                             int(apart.sum()), seed))
        floors.append(tse.rms(moved - y_port) / spread)
    floor = float(np.median(floors))
    print(f"bf16 resnet down_0: the port's output is the correctly rounded "
          f"sum at every output; gcc_tpu's is one ulp off it at "
          f"{int(apart.sum())} of {apart.size} ({100 * share:.3g} %). "
          f"rms(port - jax_bf16) / rms(jax_bf16 - jax_fp32) = {gap:.3g}; "
          f"with gcc_tpu's down_0 output in the port's forward {closed:.3g}; "
          f"the floor, as many one-ulp moves at random places against the "
          f"port's own: median {floor:.3g} of {N_PLACES} "
          f"({', '.join(f'{f:.3g}' for f in floors)})")
    assert closed <= 0.25
    # one one-ulp move of down_0 alone carries the port's own artifact past
    # the 1/4, as far as the gap
    assert max(floors) > 0.25 and gap <= 2.0 * max(floors), (gap, floors)
