"""``dcvgan_torch.utils.debug.ShapeProbe``: the identity, with a shape line
once per distinct ``(shape, dtype)`` and statistics on every call when asked,
as the JAX package's layer prints once per trace."""

import numpy as np
import torch
from torch import nn

from dcvgan_torch.utils.debug import ShapeProbe


def test_the_probe_is_the_identity_and_prints_each_shape_once(capsys):
    probe = ShapeProbe(tag="after-down3")
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    assert probe(x) is x
    probe(x.detach())
    probe(x[:1])
    probe(x.double())
    lines = capsys.readouterr().out.splitlines()
    assert lines == [
        "[shape-probe:after-down3] (2, 3, 4, 4) torch.float32",
        "[shape-probe:after-down3] (1, 3, 4, 4) torch.float32",
        "[shape-probe:after-down3] (2, 3, 4, 4) torch.float64",
    ]
    net = nn.Sequential(nn.Linear(3, 3), ShapeProbe(), nn.ReLU())
    net(torch.ones(5, 3)).sum().backward()  # gradients pass through
    assert net[0].weight.grad is not None
    assert capsys.readouterr().out == "[shape-probe] (5, 3) torch.float32\n"


def test_stats_print_on_every_call(capsys):
    probe = ShapeProbe(tag="z", stats=True)
    x = torch.tensor([[-1.0, 0.0], [1.0, 4.0]], dtype=torch.bfloat16)
    probe(x)
    probe(x)
    out = capsys.readouterr().out.splitlines()
    v = np.array([-1.0, 0.0, 1.0, 4.0])
    stats = f"[shape-probe:z] mean={v.mean():.4f} std={v.std():.4f} min=-1.0000 max=4.0000"
    assert out == ["[shape-probe:z] (2, 2) torch.bfloat16", stats, stats]
