"""Which route each flash-attention wrapper takes, on the CPU.

``kernel.route`` picks a kernel's route from the inputs' dtype and head
dim alone: f32 goes to the CUDA-core kernels; bf16 to the warp-specialised
``wgmma`` kernels where they cover the head dim (all three kernels at 64
and 128), else to the ``mma.sync`` kernels.  What no route takes
raises.  The routes themselves run only on the card
(``tests/test_torch_flash_attention_cuda.py``).
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as K

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128, 144, 160])
def test_route_by_dtype_and_head_dim(kernel, d):
    assert K.route(kernel, F32, d) == "f32"
    wgmma = d in (64, 128)
    assert K.route(kernel, BF16, d) == ("wgmma" if wgmma else "mma")


@pytest.mark.parametrize("d", [176, 192, 208, 224, 240, 256])
def test_forward_head_dims_past_the_backward_take_mma(d):
    assert K.route("fwd", BF16, d) == "mma"
    assert K.route("fwd", F32, d) == "f32"
    for kernel in ("dq", "dkv"):
        with pytest.raises(ValueError, match="head dim"):
            K.route(kernel, BF16, d)


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("d", [0, 8, 24, 65, 272])
def test_route_raises_on_a_head_dim_no_route_takes(kernel, d):
    with pytest.raises(ValueError, match="head dim"):
        K.route(kernel, BF16, d)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_route_raises_on_another_dtype(dtype):
    with pytest.raises(TypeError):
        K.route("fwd", dtype, 128)


def test_route_raises_on_an_unknown_kernel():
    with pytest.raises(ValueError, match="kernel"):
        K.route("bwd", BF16, 128)


def test_counters_reset_together():
    K.fwd_wgmma_launch_count = K.dkv_wgmma_launch_count = 3
    K.dq_wgmma_launch_count = 3
    K.launch_count = K.dq_launch_count = K.dkv_launch_count = 3
    K.reset_launch_count()
    assert (K.launch_count, K.dq_launch_count, K.dkv_launch_count,
            K.fwd_wgmma_launch_count, K.dq_wgmma_launch_count,
            K.dkv_wgmma_launch_count) == (0, 0, 0, 0, 0, 0)
