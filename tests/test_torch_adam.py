"""The Adam kernel's CPU side (``border_tpu_torch/ops/adam.py``).

On the CPU ``make_optimizer`` still builds torch's own Adam and AdamW (the
optax-parity tests of the agents hold them).  The kernel's module imports
without ``nvcc``, and its optimizers and ``adam_step`` refuse what the
kernel does not take, CPU tensors among it, before anything is built or
computed.  The kernel itself is held against torch's capturable step on the
card (``tests/test_torch_cuda.py``).
"""

import os
import subprocess
import sys

import pytest
import torch

from border_tpu_torch.agents.common import make_optimizer
from border_tpu_torch.ops import adam_step
from border_tpu_torch.ops.adam import KernelAdam, KernelAdamW

TORCH = {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW}


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_make_optimizer_is_torchs_own_on_the_cpu(name):
    opt = make_optimizer(name, 1e-3)([torch.zeros(3, requires_grad=True)])
    assert type(opt) is TORCH[name]
    group = opt.param_groups[0]
    assert not group["capturable"] and group["lr"] == 1e-3


def test_module_imports_without_nvcc_and_refuses_the_cpu(tmp_path):
    """With no ``nvcc`` to find, the module imports; the kernel's optimizer
    over CPU parameters and ``adam_step`` over CPU tensors raise before
    anything is built, and no launch is counted."""
    code = (
        "import torch\n"
        "from border_tpu_torch.ops import _build, adam\n"
        "p = torch.ones(4, requires_grad=True); p.grad = torch.ones(4)\n"
        "for fn in (lambda: adam.KernelAdam([p], lr=torch.tensor(0.1),\n"
        "                                   capturable=True),\n"
        "           lambda: adam.adam_step([p.detach()], [p.grad],\n"
        "                                  [torch.zeros(4)], [torch.zeros(4)],\n"
        "                                  [torch.zeros(())], lr=torch.tensor(0.1),\n"
        "                                  done=torch.zeros((), dtype=torch.int32))):\n"
        "    try:\n"
        "        fn()\n"
        "    except ValueError as e:\n"
        "        assert 'CUDA' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('a CPU step was taken')\n"
        "assert 'adam' not in _build._loaded, _build._loaded\n"
        "assert adam.adam_step.launches == adam.adam_step.captured == 0\n"
        "assert p[0].item() == 1.0\n"
        "try:\n"
        "    _build._nvcc()\n"
        "except RuntimeError:\n"
        "    print('no nvcc')\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # an empty directory: no nvcc on the path
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc at the fixed path the build looks in")
    assert out.stdout.strip() == "no nvcc"


def _refused(case):
    lr = torch.tensor(1e-3)

    def param(dtype=torch.float32):
        p = torch.zeros(8, dtype=dtype, requires_grad=True)
        p.grad = torch.ones_like(p)
        return p

    def ts(n=8, device="cpu"):
        return [torch.zeros(n, device=device)]

    one = [torch.zeros(())]
    done = torch.zeros((), dtype=torch.int32)
    return {
        "amsgrad": (lambda: KernelAdam([param()], lr=lr, capturable=True,
                                       amsgrad=True), "amsgrad"),
        "maximize": (lambda: KernelAdam([param()], lr=lr, capturable=True,
                                        maximize=True), "maximize"),
        "l2 decay": (lambda: KernelAdam([param()], lr=lr, capturable=True,
                                        weight_decay=1e-2), "decoupled"),
        "not capturable": (lambda: KernelAdamW([param()], lr=lr), "capturable"),
        "float rate": (lambda: KernelAdam([param()], lr=1e-3, capturable=True),
                       "rate"),
        "tensor betas": (lambda: KernelAdam(
            [param()], lr=lr, capturable=True,
            betas=(torch.tensor(0.9), torch.tensor(0.999))), "betas"),
        "bf16": (lambda: KernelAdam([param(torch.bfloat16)], lr=lr,
                                    capturable=True), "float32"),
        "cpu parameters": (lambda: KernelAdam([param()], lr=lr, capturable=True),
                           "CUDA device"),
        "lengths": (lambda: adam_step(ts(), ts() * 2, ts(), ts(), one, lr=lr,
                                      done=done), "as many"),
        "shapes": (lambda: adam_step(ts(), ts(7), ts(), ts(), one, lr=lr,
                                     done=done), "with gradient"),
        "devices": (lambda: adam_step(ts(), ts(device="meta"), ts(), ts(), one,
                                      lr=lr, done=done), "on meta"),
        "step size": (lambda: adam_step(ts(), ts(), ts(), ts(), [torch.zeros(2)],
                                        lr=lr, done=done), "one element"),
        "cpu tensors": (lambda: adam_step(ts(), ts(), ts(), ts(), one, lr=lr,
                                          done=done), "CUDA tensors"),
    }[case]


@pytest.mark.parametrize("case", ["amsgrad", "maximize", "l2 decay",
                                  "not capturable", "float rate", "tensor betas",
                                  "bf16", "cpu parameters", "lengths", "shapes",
                                  "devices", "step size", "cpu tensors"])
def test_kernel_optimizer_refuses_what_the_kernel_does_not_take(case):
    """Each input the kernel does not take raises for its own reason, on the
    CPU too, before anything is computed."""
    fn, match = _refused(case)
    with pytest.raises((ValueError, TypeError), match=match):
        fn()
