"""The basecaller's output head on the GPU: projection, softmax, ``min_prob``
floor, pad mask and cast as one kernel (``csrc/output_head.cu``).

It replaces no Pallas kernel: the JAX package leaves the head to XLA
(``sloika_tpu/basecall.py:274-289``).  The port ran it as
``nn.Softmax.forward`` (a cuBLAS product, then amax, exp, sum and divide
passes over the posterior) followed by :func:`floor_mask` (scale, add and
cast, then the pad mask): ten passes over a (T, B, K) float32 tensor, 13.8
GB at the chunked basecall's batch of 1,024 windows.  :data:`output_head`
writes the floored, masked posterior once, in its dtype; the product
bounds it (2·I·K float32 operations a frame against 4·K bytes written).

:data:`output_head` dispatches on the device of its input: the kernel for a
CUDA tensor, :func:`output_head_plain` for a CPU tensor.  ``launches``
counts kernel launches.  The kernel takes its plan from
:func:`output_head_plan`: where a block's 32 rows of logits fit in shared
memory ("stash", K up to 1,152 states) they stay there; else
("recompute") the product runs twice, a running max and sum a row in the
first sweep.

:func:`terminal_softmax` finds the network's terminal ``Softmax`` through
``Serial``, as ``training.terminal_softmax_logits`` does; the
``Basecaller`` takes the kernel where it finds one on a CUDA device.
"""
import ctypes

import torch

from sloika_tpu_torch import config, cuda_build
from sloika_tpu_torch.nn import Serial, Softmax
from sloika_tpu_torch.nn.core import affine
from sloika_tpu_torch.nn.fused_gru import SMEM_OPTIN

#: output_head.cu: rows a block, states a consumer warp's tile, states a
#: window, rows of W^T a slot of the ring, its slots, and the bytes of its
#: mbarriers ahead of the rest of shared memory
ROWS, WARP_STATES, WINDOW, STAGE_K, STAGES, BAR_BYTES = 32, 64, 512, 16, 2, 128
#: the most states a stash row holds in its warp's registers (36 a lane)
STASH_MAX_K = 32 * 36
#: the posterior dtypes the kernel writes
POST_DTYPES = (torch.float32, torch.bfloat16)


def output_head_plan(K, I, optin=SMEM_OPTIN):
    """The kernel's launch plan for K states from I features.

    :returns: {"route": "stash" or "recompute", "Ip" (I rounded up to a
        stage), "Kp" (W^T's padded row length), "Kmain" (the states of
        whole warp tiles; the rest a warp a state), "smem" (bytes)}
    """
    if K < 1 or I < 1:
        raise ValueError("the output head needs K >= 1 states and I >= 1 "
                         "features (got K {}, I {})".format(K, I))
    Ip = -(-I // STAGE_K) * STAGE_K
    Kmain = K // WARP_STATES * WARP_STATES
    # x's rows, the ring, three floats a row, W^T's columns past Kmain
    fixed = (ROWS * (Ip + 4) + STAGES * STAGE_K * WINDOW + 3 * ROWS
             + (K - Kmain) * Ip)
    plan = {"Ip": Ip, "Kp": -(-K // 4) * 4, "Kmain": Kmain}
    for route, logits in (("stash", ROWS * K),
                          ("recompute", ROWS * (WINDOW + 1))):
        smem = BAR_BYTES + 4 * (fixed + logits)
        if smem <= optin and (route != "stash" or K <= STASH_MAX_K):
            return dict(plan, route=route, smem=smem)
    raise ValueError("the output head's rows of {} features do not fit in "
                     "{} bytes of shared memory".format(I, optin))


def floor_mask(post, out_lengths, min_prob, post_dtype):
    """The ``min_prob`` floor of a (T, B, K) float32 posterior, and one-hot
    stays on the frames past each row's ``out_lengths``, in ``post_dtype``
    (sloika_tpu/basecall.py:274-289).  The cast comes after the floor and
    is exact on the stays, so it folds into the floor's add (the float32
    sum rounded to ``post_dtype`` as it is stored) and the mask runs on the
    narrow tensor: three passes at either dtype."""
    scaled = (1.0 - min_prob) * post
    post = torch.add(scaled, min_prob, out=torch.empty_like(
        scaled, dtype=post_dtype))
    del scaled
    T = post.shape[0]
    frame_mask = (torch.arange(T, device=post.device)[:, None]
                  < out_lengths[None, :])
    stay = torch.zeros(post.shape[2], dtype=post.dtype, device=post.device)
    stay[0] = 1.0
    return torch.where(frame_mask[:, :, None], post, stay).contiguous()


def _softmax(x, W, b):
    """``Softmax.forward``'s arithmetic; its temporaries die with it."""
    tmp = affine(x, W, b)
    m = torch.amax(tmp, dim=2, keepdim=True)
    out = torch.exp(tmp - m)
    return out / torch.sum(out, dim=2, keepdim=True)


def output_head_plain(x, W, b, out_lengths, min_prob, post_dtype):
    """The head as ``Softmax.forward`` and :func:`floor_mask` compute it:
    the reference of :data:`output_head`, taken for CPU tensors."""
    return floor_mask(_softmax(x, W, b), out_lengths, min_prob, post_dtype)


class OutputHead:
    """The floored, masked posterior (T, B, K) in ``post_dtype`` from the
    last hidden layer's output x (T, B, I) float32, the softmax's W (K, I)
    and b (K,), and the frames of each batch row ``out_lengths`` (B,).
    Under ``config.compute_dtype`` bfloat16 the product takes x and W
    rounded to bfloat16, as ``nn.core.affine`` does."""

    _ARGTYPES = {"output_head": [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                 + [ctypes.c_int, ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def __call__(self, x, W, b, out_lengths, min_prob, post_dtype):
        if post_dtype not in POST_DTYPES:
            raise ValueError("the output head writes a float32 or bfloat16 "
                             "posterior (got {})".format(post_dtype))
        if x.device.type == "cpu":
            return output_head_plain(x, W, b, out_lengths, min_prob,
                                     post_dtype)
        T, B, I = x.shape
        K = W.shape[0]
        dev = x.device
        x = x.contiguous()
        cuda_build.check_tensor(x, (T, B, I), torch.float32, dev, "x")
        cuda_build.check_tensor(W, (K, I), torch.float32, dev, "W")
        cuda_build.check_tensor(b, (K,), torch.float32, dev, "b")
        lengths = out_lengths.to(device=dev, dtype=torch.int64).contiguous()
        cuda_build.check_tensor(lengths, (B,), torch.int64, dev,
                                "out_lengths")
        out = torch.empty((T, B, K), dtype=post_dtype, device=dev)
        if T == 0 or B == 0:
            return out
        props = torch.cuda.get_device_properties(dev)
        plan = output_head_plan(K, I, getattr(
            props, "shared_memory_per_block_optin", SMEM_OPTIN))
        round_bf16 = config.compute_dtype == torch.bfloat16
        wt = torch.zeros((plan["Ip"], plan["Kp"]), dtype=torch.float32,
                         device=dev)
        wt[:I, :K] = (W.to(torch.bfloat16).float() if round_bf16 else W).t()
        lib = cuda_build.load("output_head", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.output_head(
                x.data_ptr(), wt.data_ptr(), b.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), T * B, B, I, plan["Ip"],
                K, plan["Kp"], plan["Kmain"], int(plan["route"] == "stash"),
                int(round_bf16), int(post_dtype == torch.bfloat16),
                float(min_prob), float(1.0 - min_prob), plan["smem"],
                torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "output_head")
        self.launches += 1
        return out


#: the head's entry point (kernel on CUDA, plain version on the CPU)
output_head = OutputHead()


def terminal_softmax(layer):
    """``(body, softmax)`` where the network ends in a ``Softmax`` reached
    through ``Serial`` (as ``training.terminal_softmax_logits`` reaches
    it), else None; ``body(x, lengths) -> (h, out_lengths)`` runs the
    layers before it through ``apply_with_lengths``."""
    if isinstance(layer, Softmax):
        return (lambda x, lengths: (x, lengths)), layer
    if isinstance(layer, Serial) and layer.layers:
        inner = terminal_softmax(layer.layers[-1])
        if inner is None:
            return None
        rest, softmax = inner

        def body(x, lengths):
            for sub in layer.layers[:-1]:
                x, lengths = sub.apply_with_lengths(x, lengths)
            return rest(x, lengths)

        return body, softmax
    return None
