"""The declarative layer API — the v2 capability surface (counterpart of
``paddle_tpu/layer.py``, with its function names, signatures, layer
names and parameter names).

Reference: python/paddle/trainer_config_helpers/layers.py (config
functions) + python/paddle/v2/layer.py. Each function here returns a
LayerOutput node holding parameter specs and a forward callable;
``topology.Topology`` compiles the graph into one plain function.

Image tensors follow the reference's flat-CHW convention at the data
boundary (images enter as flat CHW vectors) and flow as NHWC inside;
an ``fc`` over an image flattens it back to CHW first, so a parameter
has the same shape and element order in both packages. Sequences are
``[B, T, ...]`` with ``lengths``. Random draws (dropout masks,
``sampling_id``, ``nce`` negatives) are the JAX package's draws for the
same key (``ops/prng``).
"""

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch import pooling as pooling_mod
from paddle_tpu_torch.core.param import ParamAttr, ParamSpec
from paddle_tpu_torch.ops import activations as ops_act
from paddle_tpu_torch.ops import beam as ops_beam
from paddle_tpu_torch.ops import conv as ops_conv
from paddle_tpu_torch.ops import loss as ops_loss
from paddle_tpu_torch.ops import norm as ops_norm
from paddle_tpu_torch.ops import pool as ops_pool
from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.ops import rnn as ops_rnn
from paddle_tpu_torch.ops import sequence as ops_seq
from paddle_tpu_torch.ops import sparse as ops_sparse
from paddle_tpu_torch.ops import topk as ops_topk
from paddle_tpu_torch.ops.math import matmul
from paddle_tpu_torch.topology import LayerOutput, Value, auto_name
from paddle_tpu_torch.utils import enforce

# the dynamic-RNN DSL lives in recurrent.py; re-exported here to mirror the
# reference surface (recurrent_group/memory/beam_search sat beside fc)
from paddle_tpu_torch.recurrent import (recurrent_group, memory, beam_search,
                                        StaticInput, GeneratedInput)


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _param_attr(attr, default_name) -> ParamAttr:
    attr = attr or ParamAttr()
    if attr.name is None:
        attr = type(attr)(**{**attr.__dict__, "name": default_name})
    return attr


def _bias_spec(name, size, bias_attr) -> Optional[ParamSpec]:
    """bias_attr False disables bias (reference convention)."""
    if bias_attr is False:
        return None
    attr = bias_attr if isinstance(bias_attr, ParamAttr) else ParamAttr(
        initializer="constant", initial_value=0.0)
    attr = _param_attr(attr, f"{name}.b")
    return ParamSpec(attr.name, (size,), attr=attr)


def _apply_act(value: Value, act_name: str) -> Value:
    """Keeps the pre-activation on the Value so downstream cost layers can
    fuse with the activation in log-space (the reason the reference had a
    fused softmax_with_cross_entropy op). Only softmax keeps its logits."""
    if act_name == "sequence_softmax":
        enforce.enforce(value.is_sequence, "sequence_softmax needs sequence input")
        return value.with_array(ops_seq.seq_softmax(value.array, value.lengths))
    pre = value.array if act_name == "softmax" else None
    return value.with_array(ops_act.get(act_name)(value.array), pre_act=pre)


def _flatten_if_image(x: torch.Tensor) -> torch.Tensor:
    """FC over a conv output: flatten NHWC back to CHW-flat so parameter
    layouts match the reference's channel-major convention."""
    if x.dim() == 4:
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    return x


def _feat_size(x: torch.Tensor) -> int:
    if x.dim() == 4:
        return int(x.shape[1] * x.shape[2] * x.shape[3])
    return int(x.shape[-1])


def _lengths_mask(lengths, tmax):
    """[B, T] bool: step t < the row's length."""
    return torch.arange(tmax, device=lengths.device)[None, :] < \
        lengths[:, None]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def data(name: str, type):
    """Input declaration (reference: v2 layer.data / DataConfig)."""
    return LayerOutput(name, "data", [], fn=None, size=type.dim, is_data=True,
                       data_spec=type)


# ---------------------------------------------------------------------------
# fc / embedding
# ---------------------------------------------------------------------------

def fc(input, size: int, act=None, name: Optional[str] = None,
       param_attr=None, bias_attr=None):
    """Fully-connected over one or more inputs (summed), mirroring
    fc_layer's multi-input form (reference: trainer_config_helpers/layers.py
    fc_layer; gserver/layers/FullyConnectedLayer.cpp)."""
    name = name or auto_name("fc")
    inputs = _as_list(input)
    act_name = act_mod.resolve(act)
    attrs = _as_list(param_attr) if isinstance(param_attr, (list, tuple)) \
        else [param_attr] * len(inputs)
    specs = []
    for i, (inp, attr) in enumerate(zip(inputs, attrs)):
        suffix = f".w{i}" if len(inputs) > 1 else ".w"
        a = _param_attr(attr if isinstance(attr, ParamAttr) else ParamAttr(),
                        f"{name}{suffix}")
        in_size = inp.size
        specs.append(ParamSpec(a.name, (in_size, size), attr=a, fan_in=in_size))
    bias = _bias_spec(name, size, bias_attr)
    if bias:
        specs.append(bias)

    def fwd(params, parents, ctx):
        total = None
        for spec, pv in zip(specs, parents):
            if pv.is_sparse:
                # sparse input: gather rows of W by nonzero index and
                # weight-sum (reference: MulOp sparse path)
                rows = params[spec.name][pv.array.long()]     # [b, k, size]
                out = torch.sum(rows * pv.weights[..., None].to(rows.dtype),
                                dim=-2)
            else:
                x = _flatten_if_image(pv.array)
                out = matmul(x, params[spec.name])
            total = out if total is None else total + out
        if bias:
            total = total + params[bias.name].to(total.dtype)
        v = Value(total, parents[0].lengths, parents[0].sub_lengths)
        return _apply_act(v, act_name)

    return LayerOutput(name, "fc", inputs, fwd, specs, size=size,
                       activation=act_name)


def embedding(input, size: int, name: Optional[str] = None, param_attr=None,
              padding_idx: Optional[int] = None):
    """Embedding lookup (reference: v2 layer.embedding / TableProjection /
    operators/lookup_table_op.cc)."""
    name = name or auto_name("embedding")
    a = _param_attr(param_attr or ParamAttr(), f"{name}.w")
    vocab = input.size
    spec = ParamSpec(a.name, (vocab, size), attr=a, fan_in=size)

    def fwd(params, parents, ctx):
        pv = parents[0]
        out = ops_sparse.embedding_lookup(params[spec.name], pv.array,
                                          padding_idx)
        return Value(out, pv.lengths, pv.sub_lengths)

    return LayerOutput(name, "embedding", [input], fwd, [spec], size=size)


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------

def _to_nhwc(x: torch.Tensor, channels: int, img_h: Optional[int],
             img_w: Optional[int]) -> torch.Tensor:
    if x.dim() == 4:
        return x
    n, flat = x.shape
    if img_h is None:
        side = int(math.isqrt(flat // channels))
        img_h = img_w = side
    x = x.reshape(n, channels, img_h, img_w)      # reference flat layout: CHW
    return x.permute(0, 2, 3, 1)


def _infer_img_shape(input, cin, img_size):
    """Static (H, W) of a layer's image input — the config_parser
    equivalent (it tracked img dims through every conv/pool)."""
    if img_size is not None:
        return (img_size, img_size) if isinstance(img_size, int) \
            else tuple(img_size)
    shp = getattr(input, "_img_shape", None)
    if shp is not None:
        return shp
    if input.size and cin:
        side = int(math.isqrt(input.size // cin))
        if side * side * cin == input.size:
            return (side, side)
    return (None, None)


def _conv_out_dim(in_dim, k, s, pad, dilation=1):
    """Output spatial size, floor mode."""
    if in_dim is None:
        return None
    eff_k = (k - 1) * dilation + 1
    if pad == "SAME":
        return -(-in_dim // s)
    if pad == "VALID":
        p0 = p1 = 0
    elif isinstance(pad, int):
        p0 = p1 = pad
    else:
        p0, p1 = pad
    return (in_dim + p0 + p1 - eff_k) // s + 1


def img_conv(input, filter_size, num_filters: int, num_channels: Optional[int] = None,
             stride=1, padding=None, groups=1, act=None, name: Optional[str] = None,
             param_attr=None, bias_attr=None, img_size=None, dilation=1,
             trans: bool = False):
    """2-D conv layer (reference: img_conv_layer in
    trainer_config_helpers/layers.py; gserver/layers/ExpandConvLayer.cpp).
    Accepts flat-CHW or NHWC input; emits NHWC."""
    name = name or auto_name("img_conv")
    act_name = act_mod.resolve(act)
    k = (filter_size, filter_size) if isinstance(filter_size, int) else tuple(filter_size)
    user_padding = padding
    if padding is None:
        padding = ((k[0] - 1) // 2, (k[1] - 1) // 2)  # reference default: same-ish
    a = _param_attr(param_attr or ParamAttr(initializer="msra"), f"{name}.w")
    cin = num_channels
    if cin is None:
        cin = getattr(input, "_out_channels", None)
        enforce.enforce(cin is not None,
                        f"img_conv {name}: num_channels required for flat input")
    if trans:
        enforce.enforce(groups == 1 and dilation == 1,
                        "img_conv trans=True supports groups=1, dilation=1")
    wshape = (k[0], k[1], cin // groups, num_filters)
    spec = ParamSpec(a.name, wshape, attr=a, fan_in=k[0] * k[1] * (cin // groups))
    bias = _bias_spec(name, num_filters, bias_attr)
    specs = [spec] + ([bias] if bias else [])
    ih, iw = _infer_img_shape(input, cin, img_size)
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    if trans:
        if user_padding in (None, "SAME"):
            oh = ih * s[0] if ih else None
            ow = iw * s[1] if iw else None
        else:
            oh = ow = None  # non-SAME transposed shapes resolved at runtime
    else:
        pads = padding if isinstance(padding, str) else (
            (padding, padding) if isinstance(padding, int) else tuple(padding))
        ph = pads if isinstance(pads, str) else pads[0]
        pw = pads if isinstance(pads, str) else pads[1]
        oh = _conv_out_dim(ih, k[0], s[0], ph, dilation)
        ow = _conv_out_dim(iw, k[1], s[1], pw, dilation)

    def fwd(params, parents, ctx):
        x = _to_nhwc(parents[0].array, cin, ih, iw)
        if trans:
            if user_padding is None:
                tpad = "SAME"
            elif isinstance(user_padding, str):
                tpad = user_padding
            elif isinstance(user_padding, int):
                tpad = ((user_padding, user_padding),) * 2
            else:
                p = tuple(user_padding)
                tpad = ((p[0], p[0]), (p[1], p[1])) if isinstance(p[0], int) \
                    else p
            out = ops_conv.conv2d_transpose(x, params[spec.name], stride=stride,
                                            padding=tpad)
        else:
            out = ops_conv.conv2d(x, params[spec.name], stride=stride,
                                  padding=padding, dilation=dilation,
                                  groups=groups)
        if bias:
            out = out + params[bias.name].to(out.dtype)
        return _apply_act(Value(out), act_name)

    lo = LayerOutput(name, "img_conv", [input], fwd, specs,
                     size=oh * ow * num_filters if oh and ow else None,
                     activation=act_name)
    lo._out_channels = num_filters
    lo._img_shape = (oh, ow)
    return lo


def img_pool(input, pool_size, stride=None, padding=0, pool_type=None,
             num_channels=None, name: Optional[str] = None, img_size=None):
    """Image pooling (reference: img_pool_layer; gserver PoolLayer.cpp)."""
    name = name or auto_name("img_pool")
    ptype = pooling_mod.resolve(pool_type)
    cin = num_channels or getattr(input, "_out_channels", None)
    ih, iw = _infer_img_shape(input, cin, img_size)
    k = (pool_size, pool_size) if isinstance(pool_size, int) else tuple(pool_size)
    st = stride if stride is not None else pool_size
    st = (st, st) if isinstance(st, int) else tuple(st)
    pad = padding
    oh = _conv_out_dim(ih, k[0], st[0],
                       pad if isinstance(pad, (str, int)) else pad[0])
    ow = _conv_out_dim(iw, k[1], st[1],
                       pad if isinstance(pad, (str, int)) else pad[1])

    def fwd(params, parents, ctx):
        x = _to_nhwc(parents[0].array, cin, ih, iw)
        if ptype == "max":
            out = ops_pool.max_pool2d(x, pool_size, stride=stride, padding=padding)
        else:
            out = ops_pool.avg_pool2d(x, pool_size, stride=stride, padding=padding)
        return Value(out)

    lo = LayerOutput(name, "img_pool", [input], fwd, [],
                     size=oh * ow * cin if oh and ow and cin else None)
    lo._out_channels = cin
    lo._img_shape = (oh, ow)
    return lo


def spp(input, pyramid_height: int, num_channels=None, pool_type=None,
        name: Optional[str] = None):
    """Spatial pyramid pooling layer (reference: spp_layer)."""
    name = name or auto_name("spp")
    ptype = pooling_mod.resolve(pool_type)
    cin = num_channels or getattr(input, "_out_channels", None)

    def fwd(params, parents, ctx):
        x = _to_nhwc(parents[0].array, cin, None, None)
        return Value(ops_pool.spp(x, pyramid_height, ptype))

    bins = sum(4 ** l for l in range(pyramid_height))
    return LayerOutput(name, "spp", [input], fwd, [],
                       size=bins * cin if cin else None)


def img_cmrnorm(input, size=5, scale=0.0001, power=0.75, name=None,
                num_channels=None):
    """Cross-map response normalisation — AlexNet LRN (reference:
    img_cmrnorm_layer; paddle/function/CrossMapNormalOp.cpp)."""
    name = name or auto_name("cmrnorm")
    cin = num_channels or getattr(input, "_out_channels", None)
    ih, iw = _infer_img_shape(input, cin, None)

    def fwd(params, parents, ctx):
        x = _to_nhwc(parents[0].array, cin, ih, iw)
        return Value(ops_norm.lrn(x, size=size, alpha=scale, beta=power))

    lo = LayerOutput(name, "cmrnorm", [input], fwd, [], size=input.size)
    lo._out_channels = cin
    lo._img_shape = getattr(input, "_img_shape", (ih, iw))
    return lo


def batch_norm(input, act=None, name: Optional[str] = None, num_channels=None,
               param_attr=None, bias_attr=None, moving_average_fraction=0.9,
               epsilon=1e-5):
    """Batch normalisation with functional running stats (reference:
    batch_norm_layer; gserver/layers/BatchNormalizationLayer.cpp). Stats
    live in the state dict keyed '<name>.mean' / '<name>.var'; training
    returns new ones in ``new_state``."""
    name = name or auto_name("batch_norm")
    act_name = act_mod.resolve(act)
    cin = num_channels or getattr(input, "_out_channels", None) or input.size
    ga = _param_attr(param_attr if isinstance(param_attr, ParamAttr) else
                     ParamAttr(initializer="constant", initial_value=1.0),
                     f"{name}.gamma")
    ba = _param_attr(bias_attr if isinstance(bias_attr, ParamAttr) else
                     ParamAttr(initializer="constant", initial_value=0.0),
                     f"{name}.beta")
    gamma = ParamSpec(ga.name, (cin,), attr=ga)
    beta = ParamSpec(ba.name, (cin,), attr=ba)
    mean_s = ParamSpec(f"{name}.mean", (cin,),
                       attr=ParamAttr(initializer="constant", initial_value=0.0))
    var_s = ParamSpec(f"{name}.var", (cin,),
                      attr=ParamAttr(initializer="constant", initial_value=1.0))

    def fwd(params, parents, ctx):
        x = parents[0].array
        if x.dim() == 2 and x.shape[-1] != cin:
            # flat CHW image: reshape so stats are per channel
            x = _to_nhwc(x, cin, None, None)
        rm = ctx.state_in[mean_s.name]
        rv = ctx.state_in[var_s.name]
        if ctx.is_training:
            y, nm, nv = ops_norm.batch_norm_train(
                x, params[gamma.name], params[beta.name], rm, rv,
                momentum=moving_average_fraction, eps=epsilon)
            ctx.state_out[mean_s.name] = nm
            ctx.state_out[var_s.name] = nv
        else:
            y = ops_norm.batch_norm_infer(x, params[gamma.name],
                                          params[beta.name], rm, rv, eps=epsilon)
            ctx.state_out[mean_s.name] = rm
            ctx.state_out[var_s.name] = rv
        return _apply_act(Value(y, parents[0].lengths), act_name)

    lo = LayerOutput(name, "batch_norm", [input], fwd, [gamma, beta],
                     size=input.size, activation=act_name,
                     state_specs=[mean_s, var_s])
    lo._out_channels = getattr(input, "_out_channels", None)
    lo._img_shape = getattr(input, "_img_shape", None)
    return lo


def img_conv_bn(input, filter_size, num_filters: int,
                num_channels: Optional[int] = None, stride=1,
                padding="SAME", act=None, name: Optional[str] = None,
                param_attr=None, bn_param_attr=None, bn_bias_attr=None,
                moving_average_fraction=0.9, epsilon=1e-5, img_size=None,
                conv_name: Optional[str] = None,
                bn_name: Optional[str] = None, save8: bool = False):
    """Fused conv→batch-norm block (ops/conv_bn.py: closed-form two-pass
    BN backward; ``save8`` stashes the backward's saved activations as
    per-channel int8). No conv bias (BN's beta subsumes it)."""
    from paddle_tpu_torch.ops import conv_bn as ops_fused

    name = name or auto_name("img_conv_bn")
    # conv_name / bn_name control PARAMETER naming so a fused layer can
    # share checkpoints with an img_conv + batch_norm pair
    conv_name = conv_name or name
    bn_name = bn_name or name
    act_name = act_mod.resolve(act)
    k = (filter_size, filter_size) if isinstance(filter_size, int) \
        else tuple(filter_size)
    cin = num_channels or getattr(input, "_out_channels", None)
    enforce.enforce(cin is not None,
                    f"img_conv_bn {name}: num_channels required")
    a = _param_attr(param_attr or ParamAttr(initializer="msra"),
                    f"{conv_name}.w")
    wspec = ParamSpec(a.name, (k[0], k[1], cin, num_filters), attr=a,
                      fan_in=k[0] * k[1] * cin)
    ga = _param_attr(bn_param_attr if isinstance(bn_param_attr, ParamAttr)
                     else ParamAttr(initializer="constant",
                                    initial_value=1.0), f"{bn_name}.gamma")
    ba = _param_attr(bn_bias_attr if isinstance(bn_bias_attr, ParamAttr)
                     else ParamAttr(initializer="constant",
                                    initial_value=0.0), f"{bn_name}.beta")
    gamma = ParamSpec(ga.name, (num_filters,), attr=ga)
    beta = ParamSpec(ba.name, (num_filters,), attr=ba)
    mean_s = ParamSpec(f"{bn_name}.mean", (num_filters,),
                       attr=ParamAttr(initializer="constant",
                                      initial_value=0.0))
    var_s = ParamSpec(f"{bn_name}.var", (num_filters,),
                      attr=ParamAttr(initializer="constant",
                                     initial_value=1.0))
    ih, iw = _infer_img_shape(input, cin, img_size)
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    pad_for_dim = "SAME" if padding == "SAME" else padding
    oh = _conv_out_dim(ih, k[0], s[0], pad_for_dim)
    ow = _conv_out_dim(iw, k[1], s[1], pad_for_dim)

    def fwd(params, parents, ctx):
        x = _to_nhwc(parents[0].array, cin, ih, iw)
        rm = ctx.state_in[mean_s.name]
        rv = ctx.state_in[var_s.name]
        if ctx.is_training:
            y, nm, nv = ops_fused.conv_bn_train(
                x, params[wspec.name], params[gamma.name],
                params[beta.name], rm, rv, stride=stride, padding=padding,
                momentum=moving_average_fraction, eps=epsilon,
                save8=save8)
            ctx.state_out[mean_s.name] = nm
            ctx.state_out[var_s.name] = nv
        else:
            y = ops_fused.conv_bn_infer(
                x, params[wspec.name], params[gamma.name],
                params[beta.name], rm, rv, stride=stride, padding=padding,
                eps=epsilon)
            ctx.state_out[mean_s.name] = rm
            ctx.state_out[var_s.name] = rv
        return _apply_act(Value(y), act_name)

    lo = LayerOutput(name, "img_conv_bn", [input], fwd,
                     [wspec, gamma, beta],
                     size=oh * ow * num_filters if oh and ow else None,
                     activation=act_name, state_specs=[mean_s, var_s])
    lo._out_channels = num_filters
    lo._img_shape = (oh, ow)
    return lo


# ---------------------------------------------------------------------------
# q8 training pipeline layers (ops/q8.py): activations stored as int8
# ---------------------------------------------------------------------------

def _q8_state_specs(name, ch):
    """Delayed-scaling state of one stash site: the previous step's
    per-channel center and scale."""
    mean_s = ParamSpec(f"{name}.q_mean", (ch,),
                       attr=ParamAttr(initializer="constant",
                                      initial_value=0.0))
    scale_s = ParamSpec(f"{name}.q_scale", (ch,),
                        attr=ParamAttr(initializer="constant",
                                       initial_value=1.0))
    return mean_s, scale_s


def _q8_parent_fold(parent_info, params, aux, q8_mod):
    """(M, B, relu_in) of a consumer's prologue from the producer's
    deferred BN / activation (build-time info + this step's batch
    statistics)."""
    bn_name, act_name, eps = parent_info
    enforce.enforce(act_name in (None, "linear", "relu"),
                    f"q8 pipeline supports relu/None deferred activations, "
                    f"got {act_name!r}")
    relu_in = act_name == "relu"
    if bn_name is None:
        M, B = q8_mod.fold_identity(aux["mu"])
        return M, B, relu_in
    M, B = q8_mod.fold_bn_affine(aux["mu"], aux["var"],
                                 params[f"{bn_name}.gamma"],
                                 params[f"{bn_name}.beta"], eps=eps)
    return M, B, relu_in


def _q8_key(ctx, name: str, stochastic: bool):
    """The trailing key of the stochastic-rounding blocks:
    ``ctx.layer_key(name)``, the JAX package's raw key data for the
    layer and step."""
    if not stochastic:
        return ()
    key = ctx.layer_key(name)
    enforce.enforce(
        key is not None,
        f"q8 layer {name!r}: stochastic rounding needs the per-step "
        f"dropout_key threaded into forward (trainer.SGD provides it)")
    return (key,)


def _q8_info(lo: LayerOutput):
    info = getattr(lo, "_q8", None)
    enforce.enforce(info is not None,
                    f"layer {lo.name!r} is not a q8 producer — q8 layers "
                    f"can only consume q8_entry / img_conv_bn_q8 / "
                    f"addto_q8 outputs")
    return info


def q8_entry(input, name: Optional[str] = None, num_channels=None,
             stash: str = "int8", stochastic: bool = False):
    """Quantize a dense activation into the q8 pipeline (ops/q8.py):
    until ``q8_exit`` an activation is kept only as a centered int8
    stash under delayed scaling (``stash="bf16"``: the same deferral
    with a bf16 stash, the "defer" recipe). Training only; eval runs
    the exact dense math."""
    from paddle_tpu_torch.ops import q8 as ops_q8

    name = name or auto_name("q8_entry")
    cin = num_channels or getattr(input, "_out_channels", None)
    enforce.enforce(cin is not None, f"q8_entry {name}: unknown channels")
    mean_s, scale_s = _q8_state_specs(name, cin)

    def fwd(params, parents, ctx):
        v = parents[0]
        if not ctx.is_training:
            ctx.state_out[mean_s.name] = ctx.state_in[mean_s.name]
            ctx.state_out[scale_s.name] = ctx.state_in[scale_s.name]
            return v
        yhat, q, mu, amax = ops_q8.make_entry(stash, stochastic)(
            v.array, ctx.state_in[mean_s.name], ctx.state_in[scale_s.name],
            *_q8_key(ctx, name, stochastic))
        ctx.state_out[mean_s.name] = mu
        ctx.state_out[scale_s.name] = ops_q8.scale_from_amax(amax)
        return Value(yhat, aux={"q": q, "mu": mu})

    lo = LayerOutput(name, "q8_entry", [input], fwd, [],
                     size=input.size, state_specs=[mean_s, scale_s])
    lo._out_channels = cin
    lo._img_shape = getattr(input, "_img_shape", None)
    lo._q8 = (None, None, 1e-5)   # (deferred bn name, deferred act, eps)
    return lo


def img_conv_bn_q8(input, filter_size, num_filters: int,
                   num_channels: Optional[int] = None, stride: int = 1,
                   padding: int = 0, act=None, name: Optional[str] = None,
                   param_attr=None, bn_param_attr=None, bn_bias_attr=None,
                   moving_average_fraction=0.9, epsilon=1e-5,
                   conv_name: Optional[str] = None,
                   bn_name: Optional[str] = None, stash: str = "int8",
                   stochastic: bool = False):
    """Conv -> BN block on the q8 pipeline (ops/q8.py): reads the
    producer's stash (dequantize, the producer's BN affine and
    activation, in its prologue) and writes its own (centered,
    quantized). Its OWN batch-norm affine and activation are deferred to
    the q8 layer that consumes it. Parameter and state names are the
    dense img_conv + batch_norm pair's, so checkpoints interchange."""
    from paddle_tpu_torch.ops import q8 as ops_q8

    name = name or auto_name("img_conv_bn_q8")
    conv_name = conv_name or name
    bn_name = bn_name or name
    act_name = act_mod.resolve(act)
    k = (filter_size, filter_size) if isinstance(filter_size, int) \
        else tuple(filter_size)
    enforce.enforce(k[0] == k[1], "img_conv_bn_q8: square kernels only")
    cin = num_channels or getattr(input, "_out_channels", None)
    enforce.enforce(cin is not None, f"img_conv_bn_q8 {name}: channels?")
    a = _param_attr(param_attr or ParamAttr(initializer="msra"),
                    f"{conv_name}.w")
    wspec = ParamSpec(a.name, (k[0], k[1], cin, num_filters), attr=a,
                      fan_in=k[0] * k[1] * cin)
    ga = _param_attr(bn_param_attr if isinstance(bn_param_attr, ParamAttr)
                     else ParamAttr(initializer="constant",
                                    initial_value=1.0), f"{bn_name}.gamma")
    ba = _param_attr(bn_bias_attr if isinstance(bn_bias_attr, ParamAttr)
                     else ParamAttr(initializer="constant",
                                    initial_value=0.0), f"{bn_name}.beta")
    gamma = ParamSpec(ga.name, (num_filters,), attr=ga)
    beta = ParamSpec(ba.name, (num_filters,), attr=ba)
    rmean_s = ParamSpec(f"{bn_name}.mean", (num_filters,),
                        attr=ParamAttr(initializer="constant",
                                       initial_value=0.0))
    rvar_s = ParamSpec(f"{bn_name}.var", (num_filters,),
                       attr=ParamAttr(initializer="constant",
                                      initial_value=1.0))
    qmean_s, qscale_s = _q8_state_specs(name, num_filters)
    parent_name = input.name
    parent_info = _q8_info(input)
    ih, iw = _infer_img_shape(input, cin, None)
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    oh = _conv_out_dim(ih, k[0], s[0], padding)
    ow = _conv_out_dim(iw, k[1], s[1], padding)

    def fwd(params, parents, ctx):
        v = parents[0]
        mom = moving_average_fraction
        if not ctx.is_training:
            # exact dense eval: conv -> BN(running stats) -> own act
            y = ops_conv.conv2d(v.array, params[wspec.name], stride=stride,
                                padding=padding)
            y = ops_norm.batch_norm_infer(
                y, params[gamma.name], params[beta.name],
                ctx.state_in[rmean_s.name], ctx.state_in[rvar_s.name],
                eps=epsilon)
            for spec in (rmean_s, rvar_s, qmean_s, qscale_s):
                ctx.state_out[spec.name] = ctx.state_in[spec.name]
            return _apply_act(Value(y), act_name)
        M, B, relu_in = _q8_parent_fold(parent_info, params, v.aux, ops_q8)
        blk = ops_q8.make_conv_q8(stride, padding, relu_in, stash,
                                  stochastic)
        yhat, q, mu, var, amax = blk(
            v.array, v.aux["q"], params[wspec.name], M, B,
            ctx.state_in[f"{parent_name}.q_mean"],
            ctx.state_in[f"{parent_name}.q_scale"],
            ctx.state_in[qmean_s.name], ctx.state_in[qscale_s.name],
            *_q8_key(ctx, name, stochastic))
        ctx.state_out[qmean_s.name] = mu
        ctx.state_out[qscale_s.name] = ops_q8.scale_from_amax(amax)
        ctx.state_out[rmean_s.name] = (
            mom * ctx.state_in[rmean_s.name] + (1 - mom) * mu)
        ctx.state_out[rvar_s.name] = (
            mom * ctx.state_in[rvar_s.name] + (1 - mom) * var)
        return Value(yhat, aux={"q": q, "mu": mu, "var": var})

    lo = LayerOutput(name, "img_conv_bn_q8", [input], fwd,
                     [wspec, gamma, beta],
                     size=oh * ow * num_filters if oh and ow else None,
                     activation=act_name,
                     state_specs=[rmean_s, rvar_s, qmean_s, qscale_s])
    lo._out_channels = num_filters
    lo._img_shape = (oh, ow)
    lo._q8 = (bn_name, act_name, epsilon)
    return lo


def addto_q8(input: Sequence[LayerOutput], act=None,
             name: Optional[str] = None, stash: str = "int8",
             stochastic: bool = False):
    """Residual add on the q8 pipeline: applies both producers' deferred
    BN affines and activations, adds, and stashes the sum centered
    before the activation; this layer's own activation is deferred to
    its consumers."""
    from paddle_tpu_torch.ops import q8 as ops_q8

    name = name or auto_name("addto_q8")
    act_name = act_mod.resolve(act)
    inputs = list(input)
    enforce.enforce(len(inputs) == 2, "addto_q8 takes exactly two inputs")
    cin = getattr(inputs[0], "_out_channels", None)
    enforce.enforce(cin is not None, f"addto_q8 {name}: unknown channels")
    p_names = [p.name for p in inputs]
    p_infos = [_q8_info(p) for p in inputs]
    qmean_s, qscale_s = _q8_state_specs(name, cin)

    def fwd(params, parents, ctx):
        va, vb = parents
        if not ctx.is_training:
            ctx.state_out[qmean_s.name] = ctx.state_in[qmean_s.name]
            ctx.state_out[qscale_s.name] = ctx.state_in[qscale_s.name]
            return _apply_act(Value(va.array + vb.array), act_name)
        Ma, Ba, relu_a = _q8_parent_fold(p_infos[0], params, va.aux, ops_q8)
        Mb, Bb, relu_b = _q8_parent_fold(p_infos[1], params, vb.aux, ops_q8)
        blk = ops_q8.make_add_q8(relu_a, relu_b, stash, stochastic)
        yhat, q, mu, amax = blk(
            va.array, va.aux["q"], Ma, Ba,
            ctx.state_in[f"{p_names[0]}.q_mean"],
            ctx.state_in[f"{p_names[0]}.q_scale"],
            vb.array, vb.aux["q"], Mb, Bb,
            ctx.state_in[f"{p_names[1]}.q_mean"],
            ctx.state_in[f"{p_names[1]}.q_scale"],
            ctx.state_in[qmean_s.name], ctx.state_in[qscale_s.name],
            *_q8_key(ctx, name, stochastic))
        ctx.state_out[qmean_s.name] = mu
        ctx.state_out[qscale_s.name] = ops_q8.scale_from_amax(amax)
        return Value(yhat, aux={"q": q, "mu": mu})

    lo = LayerOutput(name, "addto_q8", inputs, fwd, [],
                     size=inputs[0].size, activation=act_name,
                     state_specs=[qmean_s, qscale_s])
    lo._out_channels = cin
    lo._img_shape = getattr(inputs[0], "_img_shape", None)
    lo._q8 = (None, act_name, 1e-5)
    return lo


def q8_exit(input, name: Optional[str] = None):
    """Leave the q8 pipeline: dequantize the producer's stash, apply its
    deferred BN affine and activation, return a dense Value in the
    compute dtype."""
    from paddle_tpu_torch.ops import q8 as ops_q8

    name = name or auto_name("q8_exit")
    parent_name = input.name
    parent_info = _q8_info(input)

    def fwd(params, parents, ctx):
        v = parents[0]
        if not ctx.is_training:
            return v
        M, B, relu_in = _q8_parent_fold(parent_info, params, v.aux, ops_q8)
        out = ops_q8.make_exit(relu_in)(
            v.array, v.aux["q"], M, B,
            ctx.state_in[f"{parent_name}.q_mean"],
            ctx.state_in[f"{parent_name}.q_scale"])
        return Value(out)

    lo = LayerOutput(name, "q8_exit", [input], fwd, [], size=input.size)
    lo._out_channels = getattr(input, "_out_channels", None)
    lo._img_shape = getattr(input, "_img_shape", None)
    return lo


# ---------------------------------------------------------------------------
# regularisation / elementwise composition
# ---------------------------------------------------------------------------

def dropout(input, dropout_rate: float, name: Optional[str] = None):
    """Inverted dropout (reference: dropout_layer / ExtraAttr.drop_rate).
    The mask is ``jax.random.bernoulli(layer_key, keep, shape)``: a
    uniform draw in [0, 1) below ``keep``."""
    name = name or auto_name("dropout")

    def fwd(params, parents, ctx):
        pv = parents[0]
        if not ctx.is_training or dropout_rate <= 0.0:
            return pv
        key = ctx.layer_key(name)
        enforce.enforce(key is not None,
                        "dropout in training mode needs a dropout_key")
        keep = 1.0 - dropout_rate
        x = pv.array
        u = prng.uniform(key, x.shape, 0.0, 1.0, device=x.device)
        mask = u < torch.full((), np.float32(keep), device=x.device)
        return pv.with_array(torch.where(mask, x / keep, 0.0))

    lo = LayerOutput(name, "dropout", [input], fwd, [], size=input.size)
    # elementwise: image-shape hints pass through
    lo._out_channels = getattr(input, "_out_channels", None)
    lo._img_shape = getattr(input, "_img_shape", None)
    return lo


def concat(input: Sequence[LayerOutput], name: Optional[str] = None, act=None):
    """Feature-axis concat (reference: concat_layer). When every input is an
    image layer with the same spatial shape, concatenates on the channel
    axis and stays an image; otherwise flattens and concats."""
    name = name or auto_name("concat")
    act_name = act_mod.resolve(act)
    inputs = _as_list(input)
    shapes = [getattr(i, "_img_shape", None) for i in inputs]
    chans = [getattr(i, "_out_channels", None) for i in inputs]
    image_mode = (all(c for c in chans) and all(shapes) and
                  len({s for s in shapes}) == 1 and None not in shapes[0])

    def fwd(params, parents, ctx):
        if image_mode:
            arrs = [_to_nhwc(p.array, c, s[0], s[1])
                    for p, c, s in zip(parents, chans, shapes)]
            return _apply_act(Value(torch.cat(arrs, dim=-1)), act_name)
        arrs = [_flatten_if_image(p.array) if p.array.dim() == 4 else p.array
                for p in parents]
        return _apply_act(Value(torch.cat(arrs, dim=-1),
                                parents[0].lengths), act_name)

    lo = LayerOutput(name, "concat", inputs, fwd, [],
                     size=sum(i.size for i in inputs if i.size),
                     activation=act_name)
    if image_mode:
        lo._out_channels = sum(chans)
        lo._img_shape = shapes[0]
    return lo


def addto(input: Sequence[LayerOutput], act=None, name: Optional[str] = None,
          bias_attr=False):
    """Elementwise sum (reference: addto_layer; gserver AddtoLayer.cpp)."""
    name = name or auto_name("addto")
    act_name = act_mod.resolve(act)
    inputs = _as_list(input)
    bias = _bias_spec(name, inputs[0].size, bias_attr) if inputs[0].size else None

    def fwd(params, parents, ctx):
        total = parents[0].array
        for p in parents[1:]:
            total = total + p.array
        if bias:
            total = total + params[bias.name].to(total.dtype)
        return _apply_act(Value(total, parents[0].lengths), act_name)

    lo = LayerOutput(name, "addto", inputs, fwd, [bias] if bias else [],
                     size=inputs[0].size, activation=act_name)
    lo._out_channels = getattr(inputs[0], "_out_channels", None)
    lo._img_shape = getattr(inputs[0], "_img_shape", None)
    return lo


def scaling(input, weight, name: Optional[str] = None):
    """Row-wise scale by a scalar per example (reference: scaling_layer)."""
    name = name or auto_name("scaling")

    def fwd(params, parents, ctx):
        w, x = parents[0].array, parents[1].array
        return Value(x * w.reshape((w.shape[0],) + (1,) * (x.dim() - 1)),
                     parents[1].lengths)

    return LayerOutput(name, "scaling", [weight, input], fwd, [],
                       size=input.size)


def slope_intercept(input, slope=1.0, intercept=0.0, name: Optional[str] = None):
    """y = slope*x + intercept (reference: slope_intercept_layer)."""
    name = name or auto_name("slope_intercept")

    def fwd(params, parents, ctx):
        return parents[0].with_array(parents[0].array * slope + intercept)

    return LayerOutput(name, "slope_intercept", [input], fwd, [],
                       size=input.size)


def cos_sim(a, b, scale=1.0, name: Optional[str] = None):
    """Cosine similarity rows of a vs b (reference: cos_sim layer;
    gserver CosSimLayer.cpp). Output [b, 1]."""
    name = name or auto_name("cos_sim")

    def fwd(params, parents, ctx):
        xf, yf = parents[0].array.float(), parents[1].array.float()
        num = torch.sum(xf * yf, dim=-1, keepdim=True)
        den = torch.linalg.norm(xf, dim=-1, keepdim=True) * \
            torch.linalg.norm(yf, dim=-1, keepdim=True)
        return Value(scale * num / torch.clamp_min(den, 1e-12))

    return LayerOutput(name, "cos_sim", [a, b], fwd, [], size=1)


# ---------------------------------------------------------------------------
# recurrent layers
# ---------------------------------------------------------------------------

def _masked_steps(xp, lengths, reverse, state, cell, out_of):
    """Run ``cell(x_t, state)`` over the time axis of xp [B, T, F] (reversed
    when ``reverse``); a row past its length keeps its state. Returns the
    per-step outputs ``out_of(state)`` as [B, T, H], zeroed past each
    row's length."""
    tmax = xp.shape[1]
    mask = _lengths_mask(lengths, tmax)
    outs = [None] * tmax
    for t in (range(tmax - 1, -1, -1) if reverse else range(tmax)):
        nxt = cell(xp[:, t], state)
        mt = mask[:, t, None]
        state = type(state)(*(torch.where(mt, n, s)
                              for n, s in zip(nxt, state))) \
            if isinstance(state, tuple) else torch.where(mt, nxt, state)
        outs[t] = out_of(state)
    outs = torch.stack(outs, dim=1)
    return outs * mask[..., None].to(xp.dtype)


def lstmemory(input, size: Optional[int] = None, reverse: bool = False,
              act=None, gate_act=None, name: Optional[str] = None,
              param_attr=None, bias_attr=None):
    """LSTM over a pre-projected sequence: input.size must be 4*size — the
    x@W projection is supplied by the preceding fc/mixed layer, the layer owns
    only recurrent weights, exactly the reference contract
    (reference: lstmemory in trainer_config_helpers/layers.py:3321,
    gserver/layers/LstmLayer.cpp)."""
    name = name or auto_name("lstmemory")
    enforce.enforce(input.size % 4 == 0, "lstmemory input size must be 4*size")
    size = size or input.size // 4
    enforce.enforce(input.size == 4 * size, "lstmemory input size != 4*size")
    a = _param_attr(param_attr or ParamAttr(), f"{name}.w")
    w_hh = ParamSpec(a.name, (size, 4 * size), attr=a, fan_in=size)
    bias = _bias_spec(name, 4 * size, bias_attr)
    specs = [w_hh] + ([bias] if bias else [])

    def fwd(params, parents, ctx):
        pv = parents[0]
        enforce.enforce(pv.is_sequence, "lstmemory needs sequence input")
        xp = pv.array
        if bias:
            xp = xp + params[bias.name].to(xp.dtype)
        zeros = torch.zeros((xp.shape[0], size), dtype=xp.dtype,
                            device=xp.device)
        w = params[w_hh.name]
        outs = _masked_steps(xp, pv.lengths, reverse,
                             ops_rnn.LSTMState(zeros, zeros),
                             lambda x, s: ops_rnn.lstm_cell(x, s, w),
                             lambda s: s.h)
        return Value(outs, pv.lengths, pv.sub_lengths)

    return LayerOutput(name, "lstmemory", [input], fwd, specs, size=size)


def grumemory(input, size: Optional[int] = None, reverse: bool = False,
              act=None, name: Optional[str] = None, param_attr=None,
              bias_attr=None):
    """GRU over a pre-projected sequence (input.size == 3*size)
    (reference: grumemory; gserver/layers/GatedRecurrentLayer.cpp)."""
    name = name or auto_name("grumemory")
    enforce.enforce(input.size % 3 == 0, "grumemory input size must be 3*size")
    size = size or input.size // 3
    a = _param_attr(param_attr or ParamAttr(), f"{name}.w")
    w_hh = ParamSpec(a.name, (size, 3 * size), attr=a, fan_in=size)
    bias = _bias_spec(name, 3 * size, bias_attr)
    specs = [w_hh] + ([bias] if bias else [])

    def fwd(params, parents, ctx):
        pv = parents[0]
        enforce.enforce(pv.is_sequence, "grumemory needs sequence input")
        xp = pv.array
        if bias:
            xp = xp + params[bias.name].to(xp.dtype)
        h = torch.zeros((xp.shape[0], size), dtype=xp.dtype, device=xp.device)
        w = params[w_hh.name]
        outs = _masked_steps(xp, pv.lengths, reverse, h,
                             lambda x, s: ops_rnn.gru_cell(x, s, w),
                             lambda s: s)
        return Value(outs, pv.lengths, pv.sub_lengths)

    return LayerOutput(name, "grumemory", [input], fwd, specs, size=size)


def recurrent(input, act=None, reverse: bool = False, name: Optional[str] = None,
              param_attr=None, bias_attr=False):
    """Simple full-matrix recurrent layer over a pre-projected sequence
    (reference: gserver/layers/RecurrentLayer.cpp)."""
    name = name or auto_name("recurrent")
    size = input.size
    act_name = act_mod.resolve(act or "tanh")
    a = _param_attr(param_attr or ParamAttr(), f"{name}.w")
    w_hh = ParamSpec(a.name, (size, size), attr=a, fan_in=size)
    bias = _bias_spec(name, size, bias_attr)
    specs = [w_hh] + ([bias] if bias else [])

    def fwd(params, parents, ctx):
        pv = parents[0]
        xp = pv.array
        if bias:
            xp = xp + params[bias.name].to(xp.dtype)
        outs, _ = ops_rnn.simple_rnn(
            xp, pv.lengths, None,  # input already projected by contract
            params[w_hh.name], act=ops_act.get(act_name), reverse=reverse)
        return Value(outs, pv.lengths, pv.sub_lengths)

    return LayerOutput(name, "recurrent", [input], fwd, specs, size=size,
                       activation=act_name)


# ---------------------------------------------------------------------------
# sequence layers
# ---------------------------------------------------------------------------

def pool(input, pooling_type=None, name: Optional[str] = None):
    """Sequence pooling (reference: pooling_layer; SequencePoolLayer.cpp)."""
    name = name or auto_name("seq_pool")
    ptype = pooling_mod.resolve(pooling_type)

    def fwd(params, parents, ctx):
        pv = parents[0]
        enforce.enforce(pv.is_sequence, "pooling_layer needs sequence input")
        fn = {"max": ops_seq.seq_max, "avg": ops_seq.seq_avg,
              "sum": ops_seq.seq_sum, "sqrt": ops_seq.seq_sqrt}[ptype]
        return Value(fn(pv.array, pv.lengths))

    return LayerOutput(name, "seq_pool", [input], fwd, [], size=input.size)


pooling_layer = pool


def last_seq(input, name: Optional[str] = None):
    """(reference: last_seq / SequenceLastInstanceLayer.cpp)"""
    name = name or auto_name("last_seq")

    def fwd(params, parents, ctx):
        pv = parents[0]
        return Value(ops_seq.seq_last(pv.array, pv.lengths))

    return LayerOutput(name, "last_seq", [input], fwd, [], size=input.size)


def first_seq(input, name: Optional[str] = None):
    name = name or auto_name("first_seq")

    def fwd(params, parents, ctx):
        pv = parents[0]
        return Value(ops_seq.seq_first(pv.array, pv.lengths))

    return LayerOutput(name, "first_seq", [input], fwd, [], size=input.size)


def expand(input, expand_as, name: Optional[str] = None):
    """Broadcast per-sequence vectors over timesteps (reference: expand_layer)."""
    name = name or auto_name("expand")

    def fwd(params, parents, ctx):
        v, ref = parents
        out = ops_seq.seq_expand(v.array, ref.lengths, ref.array.shape[1])
        return Value(out, ref.lengths, ref.sub_lengths)

    return LayerOutput(name, "expand", [input, expand_as], fwd, [],
                       size=input.size)


def seq_reverse(input, name: Optional[str] = None):
    name = name or auto_name("seq_reverse")

    def fwd(params, parents, ctx):
        pv = parents[0]
        return Value(ops_seq.seq_reverse(pv.array, pv.lengths), pv.lengths,
                     pv.sub_lengths)

    return LayerOutput(name, "seq_reverse", [input], fwd, [], size=input.size)


def seq_concat(a, b, name: Optional[str] = None):
    """Per-sequence time concat (reference: seq_concat_layer)."""
    name = name or auto_name("seq_concat")

    def fwd(params, parents, ctx):
        x, y = parents
        out, lens = ops_seq.seq_concat(x.array, x.lengths, y.array, y.lengths)
        return Value(out, lens)

    return LayerOutput(name, "seq_concat", [a, b], fwd, [], size=a.size)


def context_projection(input, context_len: int, context_start: Optional[int] = None,
                       name: Optional[str] = None):
    """Context-window concat as a standalone layer (reference:
    context_projection inside mixed_layer; function/ContextProjectionOp.cpp)."""
    name = name or auto_name("context_projection")
    start = context_start if context_start is not None else -(context_len // 2)

    def fwd(params, parents, ctx):
        pv = parents[0]
        out = ops_seq.context_projection(pv.array, pv.lengths, context_len, start)
        return Value(out, pv.lengths, pv.sub_lengths)

    return LayerOutput(name, "context_projection", [input], fwd, [],
                       size=input.size * context_len)


# ---------------------------------------------------------------------------
# outputs / decisions
# ---------------------------------------------------------------------------

def max_id(input, name: Optional[str] = None):
    """Argmax layer (reference: maxid_layer / MaxIdLayer.cpp)."""
    name = name or auto_name("max_id")

    def fwd(params, parents, ctx):
        pv = parents[0]
        return Value(ops_topk.max_id(pv.array), pv.lengths, pv.sub_lengths)

    return LayerOutput(name, "max_id", [input], fwd, [], size=1)


# ---------------------------------------------------------------------------
# costs
# ---------------------------------------------------------------------------

def _seq_token_cost(per_token: torch.Tensor, lengths) -> torch.Tensor:
    """Sum per-token losses over valid steps → per-sequence cost."""
    mask = _lengths_mask(lengths, per_token.shape[1]).to(per_token.dtype)
    return torch.sum(per_token * mask, dim=1)


def _cost_layer(name, layer_type, inputs, per_example_fn, size=1):
    def fwd(params, parents, ctx):
        return Value(per_example_fn(params, parents, ctx))
    return LayerOutput(name, layer_type, inputs, fwd, [], size=size)


def classification_cost(input, label, name: Optional[str] = None):
    """Softmax classification cost (reference: classification_cost in v2;
    MultiClassCrossEntropy CostLayer). Softmax-activated inputs are fused:
    CE is log_softmax of the kept logits, never -log(p). Sequence inputs
    produce per-token CE summed over each sequence."""
    name = name or auto_name("classification_cost")
    on_probs = input.activation == "softmax" or input.activation == "sequence_softmax"

    def per_example(params, parents, ctx):
        pv, lv = parents
        pred, lab = pv.array, lv.array
        logits = pv.pre_act if input.activation == "softmax" else None
        if pv.is_sequence:
            lab3 = lab if lab.dim() == 2 else lab.reshape(lab.shape[0], -1)
            if logits is not None:
                tok = ops_loss.softmax_cross_entropy(logits, lab3)
            elif on_probs:
                tok = ops_loss.cross_entropy_with_probs(pred, lab3)
            else:
                tok = ops_loss.softmax_cross_entropy(pred, lab3)
            return _seq_token_cost(tok, pv.lengths)
        lab1 = lab.reshape(-1)
        if logits is not None:
            return ops_loss.softmax_cross_entropy(logits, lab1)
        if on_probs:
            return ops_loss.cross_entropy_with_probs(pred, lab1)
        return ops_loss.softmax_cross_entropy(pred, lab1)

    return _cost_layer(name, "classification_cost", [input, label], per_example)


def cross_entropy_cost(input, label, name: Optional[str] = None):
    name = name or auto_name("cross_entropy")
    return classification_cost(input, label, name=name)


def cross_entropy_over_beam(step_scores, parents, gold_scores, gold_slot,
                            valid_mask=None, name: Optional[str] = None):
    """Globally-normalized beam-training objective (reference:
    cross_entropy_over_beam / CrossEntropyOverBeam.cpp). ``step_scores``
    [B, S·K] or [B, S, K], ``parents`` same shape (int), ``gold_scores``
    [B, S], ``gold_slot`` [B] (−1 when the gold path left the beam),
    ``valid_mask`` optional [B, K]. Emits the per-sequence loss."""
    name = name or auto_name("cross_entropy_over_beam")
    inputs = [step_scores, parents, gold_scores, gold_slot]
    if valid_mask is not None:
        inputs.append(valid_mask)

    def per_example(params, parents_v, ctx):
        sc, par, gsc, gslot = (v.array for v in parents_v[:4])
        vm = parents_v[4].array.bool() if valid_mask is not None else None
        if sc.dim() == 2:                  # flat [B, S*K] feed layout
            S = gsc.shape[1]
            sc = sc.reshape(sc.shape[0], S, -1)
            par = par.reshape(par.shape[0], S, -1)
        return ops_beam.cross_entropy_over_beam(
            sc, par.to(torch.int32), gsc,
            gslot.reshape(gslot.shape[0]).to(torch.int32), vm)

    return _cost_layer(name, "cross_entropy_over_beam", inputs, per_example)


def square_error_cost(input, label, name: Optional[str] = None):
    """(reference: square_error_cost / SumOfSquaresCostLayer)"""
    name = name or auto_name("square_error")

    def per_example(params, parents, ctx):
        return ops_loss.square_error(parents[0].array, parents[1].array)

    return _cost_layer(name, "square_error", [input, label], per_example)


regression_cost = square_error_cost
mse_cost = square_error_cost


def multi_binary_label_cross_entropy_cost(input, label, name=None):
    name = name or auto_name("multi_binary_ce")

    def per_example(params, parents, ctx):
        return ops_loss.multi_binary_cross_entropy(parents[0].array,
                                                   parents[1].array)

    return _cost_layer(name, "multi_binary_ce", [input, label], per_example)


def rank_cost(left, right, label, name: Optional[str] = None):
    """(reference: rank_cost / RankingCost)"""
    name = name or auto_name("rank_cost")

    def per_example(params, parents, ctx):
        return ops_loss.rank_cost(parents[0].array, parents[1].array,
                                  parents[2].array.reshape(-1))

    return _cost_layer(name, "rank_cost", [left, right, label], per_example)


def huber_classification_cost(input, label, name: Optional[str] = None):
    name = name or auto_name("huber_cost")

    def per_example(params, parents, ctx):
        return ops_loss.huber_classification(parents[0].array,
                                             parents[1].array.reshape(-1))

    return _cost_layer(name, "huber_cost", [input, label], per_example)


def hinge_cost(input, label, name: Optional[str] = None):
    name = name or auto_name("hinge_cost")

    def per_example(params, parents, ctx):
        return ops_loss.hinge(parents[0].array, parents[1].array.reshape(-1))

    return _cost_layer(name, "hinge_cost", [input, label], per_example)


def crf_layer(input, label, size: Optional[int] = None,
              name: Optional[str] = None, param_attr=None):
    """Linear-chain CRF cost over a sequence of emissions: the per-sequence
    negative log-likelihood, with a (#tags+2, #tags) transition parameter,
    start/end rows first (reference: crf_layer, gserver/layers/CRFLayer.cpp,
    operators/linear_chain_crf_op.cc)."""
    from paddle_tpu_torch.ops import crf as ops_crf
    name = name or auto_name("crf")
    enforce.enforce(size is None or size == input.size,
                    f"crf_layer size {size} != input size {input.size}")
    n_tags = size or input.size
    a = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                    else ParamAttr(), f"{name}.w")
    spec = ParamSpec(a.name, (n_tags + 2, n_tags), attr=a, fan_in=n_tags)

    def fwd(params, parents, ctx):
        ev, lv = parents
        enforce.enforce(ev.is_sequence, "crf_layer input must be a sequence")
        emis = ev.pre_act if ev.pre_act is not None else ev.array
        tags = lv.array.to(torch.int32)
        if tags.dim() == 3:
            tags = tags[..., 0]
        nll = -ops_crf.crf_log_likelihood(emis, tags, ev.lengths,
                                          params[spec.name])
        return Value(nll)

    return LayerOutput(name, "crf", [input, label], fwd, [spec], size=1)


def crf_decoding_layer(input, size: Optional[int] = None, label=None,
                       name: Optional[str] = None, param_attr=None):
    """Viterbi decode with a (shared) CRF transition parameter. Without
    ``label``: the best tag sequence [B, T]. With ``label``: a per-token
    0/1 mismatch mask (reference: operators/crf_decoding_op.cc:24-35,
    gserver CRFDecodingLayer)."""
    from paddle_tpu_torch.ops import crf as ops_crf
    name = name or auto_name("crf_decoding")
    enforce.enforce(size is None or size == input.size,
                    f"crf_decoding size {size} != input size {input.size}")
    n_tags = size or input.size
    a = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                    else ParamAttr(), f"{name}.w")
    spec = ParamSpec(a.name, (n_tags + 2, n_tags), attr=a, fan_in=n_tags)
    inputs = [input] + ([label] if label is not None else [])

    def fwd(params, parents, ctx):
        ev = parents[0]
        enforce.enforce(ev.is_sequence,
                        "crf_decoding_layer input must be a sequence")
        emis = ev.pre_act if ev.pre_act is not None else ev.array
        tags, _ = ops_crf.crf_decode(emis, ev.lengths, params[spec.name])
        if label is not None:
            lab = parents[1].array.to(torch.int32)
            if lab.dim() == 3:
                lab = lab[..., 0]
            mask = _lengths_mask(ev.lengths, tags.shape[1])
            err = torch.where(mask, (tags != lab).float(), 0.0)
            return Value(err, ev.lengths)
        return Value(tags, ev.lengths)

    return LayerOutput(name, "crf_decoding", inputs, fwd, [spec], size=1)


def ctc_layer(input, label, size: Optional[int] = None,
              blank: Optional[int] = None, norm_by_times: bool = False,
              name: Optional[str] = None):
    """CTC cost. ``input``: sequence layer of per-frame class scores
    (size = #labels + 1 incl. blank); ``label``: target label sequence.
    Default blank is the LAST class index, matching the v1 ctc_layer
    (gserver/layers/CTCLayer.cpp); warp_ctc_layer defaults to blank=0."""
    from paddle_tpu_torch.ops import ctc as ops_ctc
    name = name or auto_name("ctc")
    enforce.enforce(size is None or size == input.size,
                    f"ctc_layer size {size} != input size {input.size}")
    n_classes = size or input.size
    blank_idx = n_classes - 1 if blank is None else blank

    def fwd(params, parents, ctx):
        ev, lv = parents
        if ev.pre_act is not None:
            logp = torch.log_softmax(ev.pre_act.float(), dim=-1)
        elif input.activation == "softmax":
            logp = torch.log(torch.clamp_min(ev.array.float(), 1e-30))
        else:
            logp = torch.log_softmax(ev.array.float(), dim=-1)
        lab = lv.array.to(torch.int32)
        if lab.dim() == 3:
            lab = lab[..., 0]
        enforce.enforce(ev.is_sequence and lv.is_sequence,
                        "ctc_layer input and label must be sequences")
        nll = ops_ctc.ctc_loss(logp, lab, ev.lengths, lv.lengths,
                               blank=blank_idx)
        if norm_by_times:
            nll = nll / torch.clamp_min(ev.lengths.float(), 1.0)
        return Value(nll)

    return LayerOutput(name, "ctc", [input, label], fwd, [], size=1)


def warp_ctc_layer(input, label, size: Optional[int] = None, blank: int = 0,
                   norm_by_times: bool = False, name: Optional[str] = None):
    """warp-ctc flavor: blank defaults to 0 (reference: WarpCTCLayer.cpp)."""
    return ctc_layer(input, label, size=size, blank=blank,
                     norm_by_times=norm_by_times,
                     name=name or auto_name("warp_ctc"))


def gru_step(input, state, size: Optional[int] = None,
             name: Optional[str] = None, param_attr=None, bias_attr=None):
    """One GRU step for use inside recurrent_group (reference:
    gru_step_layer; GruStepLayer.cpp). ``input``: the projected step input
    [B, 3H]; ``state``: an H-wide memory."""
    name = name or auto_name("gru_step")
    size = size or input.size // 3
    a = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                    else ParamAttr(), f"{name}.w")
    w_spec = ParamSpec(a.name, (size, 3 * size), attr=a, fan_in=size)
    bias = _bias_spec(name, 3 * size, bias_attr)
    specs = [w_spec] + ([bias] if bias else [])

    def fwd(params, parents, ctx):
        xv, sv = parents
        xp = xv.array
        if bias:
            xp = xp + params[bias.name].to(xp.dtype)
        h = ops_rnn.gru_cell(xp, sv.array, params[w_spec.name])
        return Value(h, xv.lengths, xv.sub_lengths)

    return LayerOutput(name, "gru_step", [input, state], fwd, specs,
                       size=size)


def lstm_step(input, state, cell_state, size: Optional[int] = None,
              name: Optional[str] = None, param_attr=None, bias_attr=None,
              forget_bias: float = 0.0):
    """One LSTM step for recurrent_group (reference: lstm_step_layer).
    ``input``: projected step input [B, 4H]; ``state``/``cell_state``:
    H-wide memories for h and c. Returns (h_layer, c_layer) — link the h
    memory to the first and the c memory to the second."""
    name = name or auto_name("lstm_step")
    size = size or input.size // 4
    a = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                    else ParamAttr(), f"{name}.w")
    w_spec = ParamSpec(a.name, (size, 4 * size), attr=a, fan_in=size)
    bias = _bias_spec(name, 4 * size, bias_attr)
    specs = [w_spec] + ([bias] if bias else [])

    def cell(params, parents):
        xv, hv, cv = parents
        xp = xv.array
        if bias:
            xp = xp + params[bias.name].to(xp.dtype)
        return ops_rnn.lstm_cell(xp, ops_rnn.LSTMState(hv.array, cv.array),
                                 params[w_spec.name], forget_bias)

    def fwd_h(params, parents, ctx):
        return Value(cell(params, parents).h, parents[0].lengths,
                     parents[0].sub_lengths)

    h_layer = LayerOutput(name, "lstm_step", [input, state, cell_state],
                          fwd_h, specs, size=size)

    def fwd_c(params, parents, ctx):
        return Value(cell(params, parents).c, parents[0].lengths,
                     parents[0].sub_lengths)

    c_layer = LayerOutput(f"{name}@cell", "lstm_step_cell",
                          [input, state, cell_state], fwd_c, specs, size=size)
    return h_layer, c_layer


# ---------------------------------------------------------------------------
# elementwise / structural layers (reference: trainer_config_helpers/layers.py
# interpolation_layer, power_layer, sum_to_one_norm_layer, clip_layer,
# resize_layer, trans_layer, rotate_layer, repeat_layer, maxout_layer,
# multiplex_layer, out_prod_layer, tensor_layer, linear_comb_layer,
# conv_shift_layer, scale_shift_layer, prelu_layer, row_l2_norm_layer,
# gated_unit_layer, eos_layer, sampling_id_layer and their gserver/*.cpp
# implementations)
# ---------------------------------------------------------------------------

def _simple_layer(name, ltype, inputs, fn, size, activation=None, specs=(),
                  meta_from=0):
    """Stateless layer from a tensor function over parent Values.
    ``meta_from``: index of the parent whose sequence metadata carries over
    (None drops it — for layers that change the row structure)."""
    def fwd(params, parents, ctx):
        arr = fn(params, parents, ctx)
        if meta_from is None:
            return Value(arr)
        p0 = parents[meta_from]
        return Value(arr, p0.lengths, p0.sub_lengths)
    return LayerOutput(name, ltype, inputs, fwd, list(specs), size=size,
                       activation=activation)


def _per_row(w, x):
    """A per-sample scalar [B] or [B, 1] shaped to broadcast over x."""
    return w.reshape((-1,) + (1,) * (x.dim() - 1))


def interpolation(input, weight, name: Optional[str] = None):
    """out = w*x + (1-w)*y, per-sample scalar w (reference:
    interpolation_layer; InterpolationLayer.cpp)."""
    name = name or auto_name("interpolation")
    x, y = input
    enforce.enforce(x.size == y.size, "interpolation inputs must match")

    def fn(params, parents, ctx):
        x = parents[1].array
        w = _per_row(parents[0].array, x)
        return w * x + (1.0 - w) * parents[2].array

    return _simple_layer(name, "interpolation", [weight, x, y], fn,
                         x.size, meta_from=1)


def power(input, weight, name: Optional[str] = None):
    """out = x ** w, per-sample scalar w (reference: power_layer)."""
    name = name or auto_name("power")

    def fn(params, parents, ctx):
        x = parents[1].array
        return torch.pow(x, _per_row(parents[0].array, x))

    return _simple_layer(name, "power", [weight, input], fn, input.size,
                         meta_from=1)


def sum_to_one_norm(input, name: Optional[str] = None):
    """x / sum(x) per row (reference: sum_to_one_norm_layer)."""
    name = name or auto_name("sum_to_one_norm")

    def fn(params, parents, ctx):
        x = parents[0].array
        return x / torch.sum(x, dim=-1, keepdim=True)

    return _simple_layer(name, "sum_to_one_norm", [input], fn, input.size)


def row_l2_norm(input, name: Optional[str] = None, eps: float = 1e-12):
    """x / ||x||_2 per row (reference: row_l2_norm_layer)."""
    name = name or auto_name("row_l2_norm")

    def fn(params, parents, ctx):
        x = parents[0].array
        return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)

    return _simple_layer(name, "row_l2_norm", [input], fn, input.size)


def clip(input, min: float, max: float, name: Optional[str] = None):
    """elementwise clip (reference: clip_layer / clip_op.cc)."""
    name = name or auto_name("clip")
    lo, hi = min, max

    def fn(params, parents, ctx):
        return torch.clamp(parents[0].array, lo, hi)

    return _simple_layer(name, "clip", [input], fn, input.size)


def resize(input, size: int, name: Optional[str] = None):
    """Reshape the whole batch matrix to rows of ``size`` (reference:
    resize_layer — ResizeLayer.cpp reinterprets [B, D] as [B*D/size, size])."""
    name = name or auto_name("resize")

    def fn(params, parents, ctx):
        return parents[0].array.reshape(-1, size)

    return _simple_layer(name, "resize", [input], fn, size,
                         meta_from=None)


def trans(input, name: Optional[str] = None):
    """Transpose the [B, D] batch matrix (reference: trans_layer,
    TransLayer.cpp — used for tied-weight tricks)."""
    name = name or auto_name("trans")

    def fn(params, parents, ctx):
        return parents[0].array.T

    return _simple_layer(name, "trans", [input], fn, input.size,
                         meta_from=None)


def repeat(input, num_repeats: int, as_row_vector: bool = True,
           act=None, name: Optional[str] = None):
    """Tile each row n times (reference: repeat_layer, FeatureMapExpand).
    as_row_vector: [a b c] -> [a b c a b c]; else [a a b b c c]."""
    name = name or auto_name("repeat")
    act_name = act_mod.resolve(act)

    def fn(params, parents, ctx):
        x = parents[0].array
        if as_row_vector:
            out = x.repeat((1,) * (x.dim() - 1) + (num_repeats,))
        else:
            out = torch.repeat_interleave(x, num_repeats, dim=-1)
        return ops_act.get(act_name)(out)

    return _simple_layer(name, "repeat", [input], fn,
                         input.size * num_repeats, activation=act_name)


def maxout(input, groups: int, num_channels: Optional[int] = None,
           name: Optional[str] = None):
    """Max over ``groups`` consecutive channels (reference: maxout_layer,
    MaxOutLayer.cpp; new stack maxout_op.cc)."""
    name = name or auto_name("maxout")

    def fn(params, parents, ctx):
        x = parents[0].array
        if x.dim() == 4:                        # NHWC
            n, h, w, c = x.shape
            return torch.amax(x.reshape(n, h, w, c // groups, groups), dim=-1)
        n, d = x.shape
        return torch.amax(x.reshape(n, d // groups, groups), dim=-1)

    lo = _simple_layer(name, "maxout", [input], fn, input.size // groups)
    cin = getattr(input, "_out_channels", None)
    if cin:
        lo._out_channels = cin // groups
        lo._img_shape = getattr(input, "_img_shape", None)
    return lo


def multiplex(input, name: Optional[str] = None):
    """Row-wise select among inputs by an index layer (reference:
    multiplex_layer, MultiplexLayer.cpp). input[0] is the integer
    selector; input[1:] the candidates."""
    name = name or auto_name("multiplex")
    sel, cands = input[0], list(input[1:])

    def fn(params, parents, ctx):
        idx = parents[0].array.reshape(-1).long()
        stack = torch.stack([p.array for p in parents[1:]], dim=0)  # [K, B, F]
        return stack[idx, torch.arange(idx.shape[0], device=idx.device)]

    return _simple_layer(name, "multiplex", [sel] + cands, fn,
                         cands[0].size, meta_from=1)


def out_prod(a, b, name: Optional[str] = None):
    """Flattened outer product per sample (reference: out_prod_layer,
    OuterProdLayer.cpp)."""
    name = name or auto_name("out_prod")

    def fn(params, parents, ctx):
        x, y = parents[0].array, parents[1].array
        return torch.einsum("bi,bj->bij", x, y).reshape(x.shape[0], -1)

    return _simple_layer(name, "out_prod", [a, b], fn, a.size * b.size)


def tensor(a, b, size: int, act=None, name: Optional[str] = None,
           param_attr=None, bias_attr=None):
    """Bilinear tensor product out_k = a^T W_k b (reference: tensor_layer,
    TensorLayer.cpp)."""
    name = name or auto_name("tensor")
    act_name = act_mod.resolve(act)
    attr = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                       else ParamAttr(), f"{name}.w")
    w_spec = ParamSpec(attr.name, (size, a.size, b.size), attr=attr,
                       fan_in=a.size * b.size)
    bias = _bias_spec(name, size, bias_attr)
    specs = [w_spec] + ([bias] if bias else [])

    def fwd(params, parents, ctx):
        x, y = parents[0].array, parents[1].array
        out = torch.einsum("bi,kij,bj->bk", x, params[w_spec.name], y)
        if bias:
            out = out + params[bias.name].to(out.dtype)
        v = Value(out, parents[0].lengths, parents[0].sub_lengths)
        return _apply_act(v, act_name)

    return LayerOutput(name, "tensor", [a, b], fwd, specs, size=size,
                       activation=act_name)


def linear_comb(weights, vectors, size: int, name: Optional[str] = None):
    """out = sum_i w_i * v_i with vectors viewed as [M, size] per sample
    (reference: linear_comb_layer, ConvexCombinationLayer.cpp)."""
    name = name or auto_name("linear_comb")

    def fn(params, parents, ctx):
        w = parents[0].array                       # [B, M]
        v = parents[1].array.reshape(w.shape[0], w.shape[1], size)
        return torch.einsum("bm,bms->bs", w, v)

    return _simple_layer(name, "linear_comb", [weights, vectors], fn,
                         size, meta_from=1)


def conv_shift(a, b, name: Optional[str] = None):
    """Circular 1-D convolution of each row of ``a`` by the (odd-sized)
    kernel row of ``b`` (reference: conv_shift_layer, ConvShiftLayer.cpp)."""
    name = name or auto_name("conv_shift")
    enforce.enforce(b.size % 2 == 1,
                    f"conv_shift kernel size must be odd, got {b.size}")

    def fn(params, parents, ctx):
        x, k = parents[0].array, parents[1].array
        m = k.shape[-1]
        half = (m - 1) // 2
        d = x.shape[-1]
        idx = (torch.arange(d, device=x.device)[:, None] +
               torch.arange(-half, half + 1, device=x.device)[None, :]) % d
        windows = x[:, idx]                        # [B, D, M]
        return torch.einsum("bdm,bm->bd", windows, k)

    return _simple_layer(name, "conv_shift", [a, b], fn, a.size)


def scale_shift(input, name: Optional[str] = None, param_attr=None,
                bias_attr=None):
    """w*x + b with scalar learnable w (and b) (reference:
    scale_shift_layer, ScaleShiftLayer.cpp)."""
    name = name or auto_name("scale_shift")
    attr = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                       else ParamAttr(initializer="constant",
                                      initial_value=1.0), f"{name}.w")
    w_spec = ParamSpec(attr.name, (1,), attr=attr)
    bias = _bias_spec(name, 1, bias_attr)
    specs = [w_spec] + ([bias] if bias else [])

    def fn(params, parents, ctx):
        x = parents[0].array
        out = x * params[w_spec.name].to(x.dtype)
        if bias:
            out = out + params[bias.name].to(out.dtype)
        return out

    return _simple_layer(name, "scale_shift", [input], fn, input.size,
                         specs=specs)


def prelu(input, name: Optional[str] = None, param_attr=None,
          channel_shared: bool = False):
    """Parametric ReLU (reference: prelu_layer, ParameterReluLayer.cpp).
    Slope is per-channel unless channel_shared."""
    name = name or auto_name("prelu")
    channels = getattr(input, "_out_channels", None)
    nslopes = 1 if channel_shared else (channels or input.size)
    attr = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                       else ParamAttr(initializer="constant",
                                      initial_value=0.25), f"{name}.w")
    w_spec = ParamSpec(attr.name, (nslopes,), attr=attr)

    def fn(params, parents, ctx):
        x = parents[0].array
        a = params[w_spec.name].to(x.dtype)
        if x.dim() == 4 and not channel_shared:
            a = a.reshape(1, 1, 1, -1)
        return torch.where(x > 0, x, a * x)

    return _simple_layer(name, "prelu", [input], fn, input.size,
                         specs=[w_spec])


def gated_unit(input, size: int, act=None, name: Optional[str] = None,
               gate_attr=None, inproj_attr=None):
    """act(fc(x)) * sigmoid(fc_gate(x)) (reference: gated_unit_layer,
    layers.py:6458)."""
    name = name or auto_name("gated_unit")
    proj = fc(input, size=size, act=act, name=f"{name}_input",
              param_attr=inproj_attr)
    gate = fc(input, size=size, act="sigmoid", name=f"{name}_gate",
              param_attr=gate_attr)

    def fn(params, parents, ctx):
        return parents[0].array * parents[1].array

    return _simple_layer(name, "gated_unit", [proj, gate], fn, size)


def eos(input, eos_id: int, name: Optional[str] = None):
    """1.0 where the integer input equals eos_id (reference: eos_layer,
    EosIdCheckLayer.cpp)."""
    name = name or auto_name("eos")

    def fn(params, parents, ctx):
        return (parents[0].array == eos_id).float()

    return _simple_layer(name, "eos", [input], fn, 1)


def sampling_id(input, name: Optional[str] = None):
    """Sample an id per row from the input distribution (reference:
    sampling_id_layer, SamplingIdLayer.cpp): ``jax.random.categorical``
    of log(p) under the per-layer key (the log as XLA:CPU computes it,
    ``prng.xla_log``), so the ids are the JAX package's; argmax when no
    key is present (deterministic eval)."""
    name = name or auto_name("sampling_id")

    def fwd(params, parents, ctx):
        p = parents[0].array
        key = ctx.layer_key(name)
        if key is None:
            ids = torch.argmax(p, dim=-1)
        else:
            ids = prng.categorical(
                key, prng.xla_log(torch.clamp_min(p.float(), 1e-30)))
        return Value(ids.to(torch.int32), parents[0].lengths)

    return LayerOutput(name, "sampling_id", [input], fwd, [], size=1)


# ---------------------------------------------------------------------------
# image geometry / 3D layers (reference: pad_layer PadLayer.cpp, crop_layer
# CropLayer.cpp, bilinear_interp_layer BilinearInterpLayer.cpp, rotate_layer
# RotateLayer.cpp, cross_channel_norm_layer CrossChannelNormLayer,
# block_expand_layer BlockExpandLayer.cpp, img_conv3d/img_pool3d)
# ---------------------------------------------------------------------------

def _img_layer(name, ltype, input, fn, out_c, out_h, out_w, extra_specs=()):
    c_in, h_in, w_in = _img_in_shape(input)

    def fwd(params, parents, ctx):
        x = _to_nhwc(parents[0].array, c_in, h_in, w_in)
        return Value(fn(params, x, ctx))
    lo = LayerOutput(name, ltype, [input], fwd, list(extra_specs),
                     size=out_c * out_h * out_w)
    lo._out_channels = out_c
    lo._img_shape = (out_h, out_w)
    return lo


def _img_in_shape(input):
    """(channels, H, W) of a layer's image output, via the conv-layer shape
    hints (_out_channels/_img_shape, the config_parser ImgSize equivalent)."""
    c = getattr(input, "_out_channels", None) or 1
    h, w = _infer_img_shape(input, c, None)
    return c, h, w


def pad(input, pad_c=(0, 0), pad_h=(0, 0), pad_w=(0, 0),
        name: Optional[str] = None):
    """Zero-pad channels/height/width (reference: pad_layer, PadLayer.cpp)."""
    name = name or auto_name("pad")
    c, h, w = _img_in_shape(input)
    oc, oh, ow = c + sum(pad_c), h + sum(pad_h), w + sum(pad_w)

    def fn(params, x, ctx):
        return F.pad(x, tuple(pad_c) + tuple(pad_w) + tuple(pad_h))

    return _img_layer(name, "pad", input, fn, oc, oh, ow)


def crop(input, offset, shape, name: Optional[str] = None):
    """Static crop of CHW dims: offset/shape are (c, h, w) triples
    (reference: crop_layer, CropLayer.cpp / crop_op.cc)."""
    name = name or auto_name("crop")
    oc, oh, ow = shape

    def fn(params, x, ctx):
        co, ho, wo = offset
        return x[:, ho:ho + oh, wo:wo + ow, co:co + oc]

    return _img_layer(name, "crop", input, fn, oc, oh, ow)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of ``jax.image.resize(..., "bilinear")`` along
    one axis (``jax.image.scale_and_translate``'s ``compute_weight_mat``):
    half-pixel centres, a triangle kernel widened by 1/scale when
    downsampling (antialiasing), columns normalised to sum 1, and samples
    outside the input zeroed. float32, as JAX computes it."""
    f32 = torch.float32
    inv = np.float32(1.0 / (n_out / n_in))
    kscale = np.float32(max(inv, 1.0))
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=f32,
                                                 device=device)[:, None]) / kscale
    w = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    tot = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def bilinear_interp(input, out_size_x: int, out_size_y: int,
                    name: Optional[str] = None):
    """Bilinear resize (reference: bilinear_interp_layer,
    BilinearInterpLayer.cpp): ``jax.image.resize(..., "bilinear")``, one
    weight-matrix product per axis whose size changes."""
    name = name or auto_name("bilinear_interp")
    c, h, w = _img_in_shape(input)

    def fn(params, x, ctx):
        if x.shape[1] != out_size_y:
            wh = _resize_weights(x.shape[1], out_size_y, x.device).to(x.dtype)
            x = torch.einsum("nhwc,ho->nowc", x, wh)
        if x.shape[2] != out_size_x:
            ww = _resize_weights(x.shape[2], out_size_x, x.device).to(x.dtype)
            x = torch.einsum("nhwc,wo->nhoc", x, ww)
        return x

    return _img_layer(name, "bilinear_interp", input, fn, c, out_size_y,
                      out_size_x)


def rotate(input, height: Optional[int] = None, width: Optional[int] = None,
           name: Optional[str] = None):
    """Rotate each feature map 90° counter-clockwise (reference:
    rotate_layer, RotateLayer.cpp)."""
    name = name or auto_name("rotate")
    c, h0, w0 = _img_in_shape(input)
    h, w = height or h0, width or w0

    def fwd(params, parents, ctx):
        x = _to_nhwc(parents[0].array, c, h, w)
        return Value(torch.rot90(x, k=1, dims=(1, 2)))

    lo = LayerOutput(name, "rotate", [input], fwd, [], size=c * h * w)
    lo._out_channels = c
    lo._img_shape = (w, h)
    return lo


def switch_order(input, reshape_order=None, name: Optional[str] = None):
    """NCHW <-> NHWC reorder of the flat representation (reference:
    switch_order_layer, SwitchOrderLayer.cpp): the flat output is
    HWC-major."""
    name = name or auto_name("switch_order")
    c, h, w = _img_in_shape(input)

    def fwd(params, parents, ctx):
        x = _to_nhwc(parents[0].array, c, h, w)
        return Value(x.reshape(x.shape[0], -1))     # HWC-major flat

    return LayerOutput(name, "switch_order", [input], fwd, [],
                       size=c * h * w)


def cross_channel_norm(input, name: Optional[str] = None, param_attr=None):
    """L2-normalize across channels at each spatial position, with a
    learned per-channel scale (reference: cross_channel_norm_layer — the
    SSD detection normalizer)."""
    name = name or auto_name("cross_channel_norm")
    c, h, w = _img_in_shape(input)
    attr = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                       else ParamAttr(initializer="constant",
                                      initial_value=1.0), f"{name}.w")
    w_spec = ParamSpec(attr.name, (c,), attr=attr)

    def fn(params, x, ctx):
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-10)
        return x / norm * params[w_spec.name].to(x.dtype)

    return _img_layer(name, "cross_channel_norm", input, fn, c, h, w,
                      extra_specs=[w_spec])


def scale_sub_region(input, indices, value: float,
                     name: Optional[str] = None):
    """Scale a per-sample CHW sub-region by ``value``; indices rows are
    1-based [c1, c2, h1, h2, w1, w2] (reference: scale_sub_region_layer,
    ScaleSubRegionLayer.cpp)."""
    name = name or auto_name("scale_sub_region")
    c, h, w = _img_in_shape(input)

    def fwd(params, parents, ctx):
        x = _to_nhwc(parents[0].array, c, h, w)
        idx = parents[1].array.to(torch.int32)      # [B, 6]
        dev = x.device
        ci = torch.arange(c, device=dev)[None, None, None, :]
        hi = torch.arange(h, device=dev)[None, :, None, None]
        wi = torch.arange(w, device=dev)[None, None, :, None]

        def rng(k):
            return idx[:, k][:, None, None, None] - 1
        mask = ((ci >= rng(0)) & (ci <= rng(1)) &
                (hi >= rng(2)) & (hi <= rng(3)) &
                (wi >= rng(4)) & (wi <= rng(5)))
        return Value(torch.where(mask, x * value, x))

    lo = LayerOutput(name, "scale_sub_region", [input, indices], fwd, [],
                     size=c * h * w)
    lo._out_channels = c
    lo._img_shape = (h, w)
    return lo


def block_expand(input, block_x: int, block_y: int, stride_x: int = 1,
                 stride_y: int = 1, padding_x: int = 0, padding_y: int = 0,
                 num_channels: Optional[int] = None,
                 name: Optional[str] = None):
    """im2col as a sequence: each sliding block becomes one timestep
    (reference: block_expand_layer, BlockExpandLayer.cpp). A timestep is
    the block in C-major (c, y, x) order, as
    ``lax.conv_general_dilated_patches`` orders it: ``F.unfold`` of NCHW."""
    name = name or auto_name("block_expand")
    if num_channels is not None:
        c = num_channels
        h, w = _infer_img_shape(input, c, None)
    else:
        c, h, w = _img_in_shape(input)
    oh = (h + 2 * padding_y - block_y) // stride_y + 1
    ow = (w + 2 * padding_x - block_x) // stride_x + 1

    def fwd(params, parents, ctx):
        x = _to_nhwc(parents[0].array, c, h, w).permute(0, 3, 1, 2)
        patches = F.unfold(x, (block_y, block_x), padding=(padding_y, padding_x),
                           stride=(stride_y, stride_x))   # [B, C*by*bx, L]
        B = x.shape[0]
        seq = patches.permute(0, 2, 1)
        lengths = torch.full((B,), oh * ow, dtype=torch.int32, device=x.device)
        return Value(seq, lengths)

    return LayerOutput(name, "block_expand", [input], fwd, [],
                       size=c * block_x * block_y)


def _ndhwc(x, c, d, h, w):
    """Flat channel-major (C, D, H, W) rows -> NDHWC."""
    if x.dim() == 2:
        return x.reshape(x.shape[0], c, d, h, w).permute(0, 2, 3, 4, 1)
    return x


def _flat_cdhw(out):
    """NDHWC -> flat channel-major (C, D, H, W) rows, so chained 3-D layers
    re-interpret the flat vector consistently."""
    return out.permute(0, 4, 1, 2, 3).reshape(out.shape[0], -1)


def img_conv3d(input, filter_size, num_filters: int, shape,
               num_channels: Optional[int] = None, stride=1, padding=0,
               act=None, name: Optional[str] = None, param_attr=None,
               bias_attr=None):
    """3-D convolution over DHW volumes; ``shape``=(C, D, H, W) of the input
    (reference: img_conv3d_layer; conv3d_op.cc)."""
    name = name or auto_name("conv3d")
    act_name = act_mod.resolve(act)
    cin, d, h, w = shape
    cin = num_channels or cin
    k = (filter_size,) * 3 if isinstance(filter_size, int) else tuple(filter_size)
    s = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    p = (padding,) * 3 if isinstance(padding, int) else tuple(padding)
    attr = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                       else ParamAttr(), f"{name}.w")
    w_spec = ParamSpec(attr.name, k + (cin, num_filters), attr=attr,
                       fan_in=cin * k[0] * k[1] * k[2])
    bias = _bias_spec(name, num_filters, bias_attr)
    specs = [w_spec] + ([bias] if bias else [])
    od = (d + 2 * p[0] - k[0]) // s[0] + 1
    oh = (h + 2 * p[1] - k[1]) // s[1] + 1
    ow = (w + 2 * p[2] - k[2]) // s[2] + 1

    def fwd(params, parents, ctx):
        x = _ndhwc(parents[0].array, cin, d, h, w)
        out = ops_conv.conv3d(x, params[w_spec.name].to(x.dtype), stride=s,
                              padding=[(pi, pi) for pi in p])
        if bias:
            out = out + params[bias.name].to(out.dtype)
        return _apply_act(Value(_flat_cdhw(out)), act_name)

    lo = LayerOutput(name, "conv3d", [input], fwd, specs,
                     size=num_filters * od * oh * ow, activation=act_name)
    lo.shape3d = (num_filters, od, oh, ow)
    return lo


def img_pool3d(input, pool_size, shape, stride=None, padding=0,
               pool_type=None, name: Optional[str] = None):
    """3-D max/avg pooling; ``shape``=(C, D, H, W) (reference:
    img_pool3d_layer; pool3d_op.cc). The average divides by the whole
    window, padding included, as the reference's reduce_window sum does."""
    name = name or auto_name("pool3d")
    c, d, h, w = shape
    k = (pool_size,) * 3 if isinstance(pool_size, int) else tuple(pool_size)
    s = k if stride is None else ((stride,) * 3 if isinstance(stride, int)
                                  else tuple(stride))
    p = (padding,) * 3 if isinstance(padding, int) else tuple(padding)
    is_avg = pooling_mod.resolve(pool_type) == "avg"
    od = (d + 2 * p[0] - k[0]) // s[0] + 1
    oh = (h + 2 * p[1] - k[1]) // s[1] + 1
    ow = (w + 2 * p[2] - k[2]) // s[2] + 1

    def fwd(params, parents, ctx):
        x = _ndhwc(parents[0].array, c, d, h, w)
        pads = [(pi, pi) for pi in p]
        if is_avg:
            out = ops_pool.avg_pool3d(x, k, stride=s, padding=pads)
        else:
            out = ops_pool.max_pool3d(x, k, stride=s, padding=pads)
        return Value(_flat_cdhw(out))

    lo = LayerOutput(name, "pool3d", [input], fwd, [],
                     size=c * od * oh * ow)
    lo.shape3d = (c, od, oh, ow)
    return lo


# ---------------------------------------------------------------------------
# sequence slicing (reference: seq_reshape_layer SequenceReshapeLayer.cpp,
# seq_slice_layer SeqSliceLayer.cpp, sub_seq_layer SubSequenceLayer.cpp,
# kmax_seq_score_layer KmaxSeqScoreLayer.cpp)
# ---------------------------------------------------------------------------

def seq_reshape(input, reshape_size: int, name: Optional[str] = None):
    """Re-tokenize a sequence: total per-sequence features regrouped into
    tokens of ``reshape_size`` (reference: seq_reshape_layer)."""
    name = name or auto_name("seq_reshape")
    enforce.enforce(input.size % reshape_size == 0 or
                    reshape_size % input.size == 0,
                    "seq_reshape sizes must divide")

    def fwd(params, parents, ctx):
        pv = parents[0]
        x = pv.array                               # [B, T, F]
        B, T, Fd = x.shape
        out = x.reshape(B, T * Fd // reshape_size, reshape_size)
        lengths = (pv.lengths * Fd) // reshape_size
        return Value(out, lengths)

    return LayerOutput(name, "seq_reshape", [input], fwd, [],
                       size=reshape_size)


def _shifted_rows(x, start):
    """x[b, min(t + start[b], T - 1)] for every t: [B, T, ...]."""
    B, T = x.shape[:2]
    idx = torch.clamp_max(torch.arange(T, device=x.device)[None, :]
                          + start[:, None].long(), T - 1)
    return x[torch.arange(B, device=x.device)[:, None], idx]


def seq_slice(input, starts=None, ends=None, name: Optional[str] = None):
    """Slice each sequence to [start, end) given per-sample scalar layers
    (reference: seq_slice_layer)."""
    name = name or auto_name("seq_slice")
    parents = [input] + [l for l in (starts, ends) if l is not None]

    def fwd(params, parent_vals, ctx):
        pv = parent_vals[0]
        x, lens = pv.array, pv.lengths
        B = x.shape[0]
        i = 1
        if starts is not None:
            s = parent_vals[i].array.reshape(-1).to(torch.int32)
            i += 1
        else:
            s = torch.zeros((B,), dtype=torch.int32, device=x.device)
        if ends is not None:
            e = parent_vals[i].array.reshape(-1).to(torch.int32)
        else:
            e = lens
        e = torch.minimum(e, lens)
        return Value(_shifted_rows(x, s), torch.clamp_min(e - s, 0))

    return LayerOutput(name, "seq_slice", parents, fwd, [], size=input.size)


def sub_seq(input, offsets, sizes, name: Optional[str] = None):
    """Per-sample subsequence by (offset, size) layers (reference:
    sub_seq_layer, SubSequenceLayer.cpp)."""
    name = name or auto_name("sub_seq")

    def fwd(params, parent_vals, ctx):
        pv = parent_vals[0]
        x, lens = pv.array, pv.lengths
        off = parent_vals[1].array.reshape(-1).to(torch.int32)
        sz = parent_vals[2].array.reshape(-1).to(torch.int32)
        new_len = torch.minimum(torch.clamp_min(sz, 0),
                                torch.clamp_min(lens - off, 0))
        return Value(_shifted_rows(x, off), new_len)

    return LayerOutput(name, "sub_seq", [input, offsets, sizes], fwd, [],
                       size=input.size)


def sub_nested_seq(input, selection, name: Optional[str] = None):
    """Select sub-sequences from a nested sequence (reference:
    sub_nested_seq_layer, SubNestedSequenceLayer.cpp). ``input`` must be a
    2-level LoD sequence (sub_lengths set); ``selection`` is an integer
    sequence of the indices of the sub-sequences to keep (its lengths give
    how many per sample). The output is again a nested sequence."""
    name = name or auto_name("sub_nested_seq")

    def fwd(params, parent_vals, ctx):
        pv, sel = parent_vals
        if pv.sub_lengths is None:
            raise ValueError(
                f"sub_nested_seq {name}: input has no sub-sequence "
                f"structure (sub_lengths is None)")
        if sel.lengths is None:
            raise ValueError(
                f"sub_nested_seq {name}: selection must be a sequence "
                f"input (its lengths give how many are selected)")
        out, new_len, new_sub = ops_seq.sub_nested_seq(
            pv.array, pv.sub_lengths, sel.array.to(torch.int32),
            sel.lengths.to(torch.int32))
        return Value(out, new_len, new_sub)

    return LayerOutput(name, "sub_nested_seq", [input, selection], fwd, [],
                       size=input.size)


def kmax_seq_score(input, beam_size: int = 1, name: Optional[str] = None):
    """Indices of the k largest per-token scores in each sequence
    (reference: kmax_seq_score_layer, KmaxSeqScoreLayer.cpp)."""
    name = name or auto_name("kmax_seq_score")

    def fwd(params, parents, ctx):
        pv = parents[0]
        scores = pv.array
        if scores.dim() == 3:
            scores = scores[..., 0]
        return Value(ops_seq.kmax_score_indices(scores, pv.lengths, beam_size))

    return LayerOutput(name, "kmax_seq_score", [input], fwd, [],
                       size=beam_size)


def printer(input, name: Optional[str] = None, format: str = "{}"):
    """Debug-print a layer's value at run time (reference: printer_layer,
    PrintLayer.cpp). Prints from the host the text ``jax.debug.print``
    gives: the name, then ``format`` filled with the value as an array."""
    name = name or auto_name("printer")

    def fwd(params, parents, ctx):
        arr = parents[0].array.detach()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        print(name + ": " + format.format(arr.cpu().numpy()))
        return parents[0]

    return LayerOutput(name, "printer", [input], fwd, [], size=input.size)


# ---------------------------------------------------------------------------
# mixed layer + sampled-output layers
# ---------------------------------------------------------------------------

def mixed(size: Optional[int] = None, input=None, act=None,
          bias_attr=False, name: Optional[str] = None):
    """Sum of projections/operators (reference: mixed_layer,
    MixedLayer.cpp — the composite of Projection/Operator sub-units)."""
    from paddle_tpu_torch import projection as proj_mod
    name = name or auto_name("mixed")
    projs = _as_list(input)
    for pr in projs:
        enforce.enforce(isinstance(pr, proj_mod.Projection),
                        "mixed() inputs must be projections/operators")
    out_size = size or projs[0].size
    for pr in projs:
        enforce.enforce(pr.size == out_size,
                        f"projection size {pr.size} != mixed size {out_size}")
    act_name = act_mod.resolve(act)
    specs = []
    seen = set()
    for pr in projs:
        for sp in pr.param_specs:
            if sp.name not in seen:
                seen.add(sp.name)
                specs.append(sp)
    bias = _bias_spec(name, out_size, bias_attr)
    if bias:
        specs.append(bias)
    parents = []
    slices = []
    for pr in projs:
        lo = len(parents)
        parents.extend(pr.inputs)
        slices.append((pr, lo, len(parents)))

    def fwd(params, parent_vals, ctx):
        total = None
        for pr, lo, hi in slices:
            out = pr.apply(params, parent_vals[lo:hi], ctx)
            total = out if total is None else total + out
        if bias:
            total = total + params[bias.name].to(total.dtype)
        p0 = parent_vals[0]
        return _apply_act(Value(total, p0.lengths, p0.sub_lengths), act_name)

    return LayerOutput(name, "mixed", parents, fwd, specs, size=out_size,
                       activation=act_name)


mixed_layer = mixed


def selective_fc(input, select, size: int, act=None,
                 name: Optional[str] = None, param_attr=None,
                 bias_attr=None):
    """FC evaluated only on selected output columns (reference:
    selective_fc_layer, SelectiveFullyConnectedLayer.cpp). ``select``:
    integer ids [B, K]; output [B, K] scores aligned with the ids: a
    gather of W's columns and a batched dot."""
    name = name or auto_name("selective_fc")
    act_name = act_mod.resolve(act)
    a = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                    else ParamAttr(), f"{name}.w")
    w_spec = ParamSpec(a.name, (input.size, size), attr=a, fan_in=input.size)
    bias = _bias_spec(name, size, bias_attr)
    specs = [w_spec] + ([bias] if bias else [])

    def fwd(params, parents, ctx):
        x = parents[0].array                       # [B, D]
        sel = parents[1].array.long()              # [B, K]
        w_cols = params[w_spec.name].T[sel]        # [B, K, D]
        out = torch.einsum("bkd,bd->bk", w_cols.to(x.dtype), x)
        if bias:
            out = out + params[bias.name][sel].to(out.dtype)
        return _apply_act(Value(out), act_name)

    return LayerOutput(name, "selective_fc", [input, select], fwd, specs,
                       size=size, activation=act_name)


def nce(input, label, num_classes: int, num_neg_samples: int = 10,
        name: Optional[str] = None, param_attr=None, bias_attr=None):
    """Noise-contrastive estimation cost over a big softmax (reference:
    nce_layer, NCELayer.cpp — binary logistic on the true class plus sampled
    noise classes; uniform noise distribution).

    Negatives are ``jax.random.randint`` under the per-layer key
    (``prng.randint``), ``PRNGKey(0)`` without a key. Returns per-example
    cost."""
    name = name or auto_name("nce")
    inputs = _as_list(input)
    a = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                    else ParamAttr(), f"{name}.w")
    specs = []
    w_specs = []
    for i, inp in enumerate(inputs):
        nm = a.name if len(inputs) == 1 else f"{a.name}{i}"
        sp = ParamSpec(nm, (num_classes, inp.size), attr=type(a)(
            **{**a.__dict__, "name": nm}), fan_in=inp.size)
        w_specs.append(sp)
        specs.append(sp)
    bias = _bias_spec(name, num_classes, bias_attr)
    if bias:
        specs.append(bias)

    def fwd(params, parents, ctx):
        xs = parents[:-1]
        lab = parents[-1].array.reshape(-1).long()
        B = lab.shape[0]
        key = ctx.layer_key(name)
        if key is None:
            key = prng.prng_key(0)
        negs = prng.randint(key, (B, num_neg_samples), 0, num_classes,
                            device=lab.device)
        ids = torch.cat([lab[:, None], negs], dim=1)  # [B, 1+S]
        total = None
        for sp, xv in zip(w_specs, xs):
            w_rows = params[sp.name][ids]               # [B, S, D]
            o = torch.einsum("bsd,bd->bs", w_rows.float(), xv.array.float())
            total = o if total is None else total + o
        if bias:
            total = total + params[bias.name][ids]
        pos_loss = F.softplus(-total[:, 0])
        neg_loss = torch.sum(F.softplus(total[:, 1:]), dim=1)
        return Value(pos_loss + neg_loss)

    return LayerOutput(name, "nce", inputs + [label], fwd, specs, size=1)


def hsigmoid(input, label, num_classes: int, name: Optional[str] = None,
             param_attr=None, bias_attr=None):
    """Hierarchical sigmoid cost: binary logistic along the complete-binary-
    tree path of the label class (reference: hsigmoid,
    HierarchicalSigmoidLayer.cpp — leaves numbered c+num_classes, internal
    nodes are the label's ancestors). Cost is -log p(label)."""
    name = name or auto_name("hsigmoid")
    inputs = _as_list(input)
    a = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                    else ParamAttr(), f"{name}.w")
    specs, w_specs = [], []
    for i, inp in enumerate(inputs):
        nm = a.name if len(inputs) == 1 else f"{a.name}{i}"
        sp = ParamSpec(nm, (num_classes - 1, inp.size), attr=type(a)(
            **{**a.__dict__, "name": nm}), fan_in=inp.size)
        w_specs.append(sp)
        specs.append(sp)
    bias = _bias_spec(name, num_classes - 1, bias_attr)
    if bias:
        specs.append(bias)
    depth = max(1, math.ceil(math.log2(num_classes)))

    def fwd(params, parents, ctx):
        xs = parents[:-1]
        lab = parents[-1].array.reshape(-1).long()
        leaf = lab + num_classes
        # ancestors leaf>>1 .. 1; child bit at each
        ks = torch.arange(1, depth + 1, device=lab.device)
        anc = leaf[:, None] >> ks[None, :]            # [B, depth]
        bit = (leaf[:, None] >> (ks[None, :] - 1)) & 1
        valid = anc >= 1
        node = torch.clamp_min(anc - 1, 0)            # weight row index
        total = None
        for sp, xv in zip(w_specs, xs):
            w_rows = params[sp.name][node]            # [B, depth, D]
            o = torch.einsum("bkd,bd->bk", w_rows.float(), xv.array.float())
            total = o if total is None else total + o
        if bias:
            total = total + params[bias.name][node]
        # p(child=right)=sigmoid(s): step cost = softplus(-s) if bit==1
        # (going right) else softplus(s)
        step_cost = torch.where(bit == 1, F.softplus(-total),
                                F.softplus(total))
        return Value(torch.sum(torch.where(valid, step_cost, 0.0), dim=1))

    return LayerOutput(name, "hsigmoid", inputs + [label], fwd, specs,
                       size=1)


# ---------------------------------------------------------------------------
# detection suite (reference: priorbox_layer, multibox_loss_layer,
# detection_output_layer, roi_pool_layer — gserver/layers/PriorBox.cpp,
# MultiBoxLossLayer.cpp, DetectionOutputLayer.cpp, ROIPoolLayer.cpp).
# Ground-truth boxes feed as a padded Value [B, G, 5] = (class, x1, y1,
# x2, y2) with lengths = #boxes per image. The JAX package maps each image
# with vmap; the port loops over the batch.
# ---------------------------------------------------------------------------

def priorbox(input, image_size, min_size, max_size=None,
             aspect_ratio=(2.0,), variance=(0.1, 0.1, 0.2, 0.2),
             name: Optional[str] = None):
    """SSD prior boxes for one feature map → [P, 4] plus variances kept as
    a layer attribute (reference: priorbox_layer / PriorBox.cpp)."""
    from paddle_tpu_torch.ops import detection as ops_det
    name = name or auto_name("priorbox")
    c, fh, fw = _img_in_shape(input)
    ih, iw = ((image_size, image_size) if isinstance(image_size, int)
              else tuple(image_size))
    # a build-time constant, made on the host and copied to each device
    # once (at its first forward, before any graph capture)
    boxes = ops_det.prior_boxes(fh, fw, ih, iw, min_size, max_size,
                                aspect_ratios=tuple(aspect_ratio),
                                device="cpu")
    nprior = boxes.shape[0]
    on_device = {}

    def fwd(params, parents, ctx):
        dev = parents[0].array.device
        if dev not in on_device:
            on_device[dev] = boxes.to(dev)
        return Value(on_device[dev])

    lo = LayerOutput(name, "priorbox", [input], fwd, [], size=nprior * 4)
    lo.num_priors = nprior
    lo.variances = tuple(variance)
    return lo


def _detection_heads(loc_v, conf_v, pb_v, num_classes):
    """(priors [P, 4], loc [B, P, 4], conf [B, P, C]) from the per-map
    heads, concatenated in order."""
    priors = torch.cat([p.array for p in pb_v], dim=0)
    P = priors.shape[0]
    B = loc_v[0].array.shape[0]
    loc = torch.cat([v.array.reshape(B, -1) for v in loc_v],
                    dim=1).reshape(B, P, 4)
    conf = torch.cat([v.array.reshape(B, -1) for v in conf_v],
                     dim=1).reshape(B, P, num_classes)
    return priors, loc, conf


def multibox_loss(input_loc, input_conf, priorbox, label,
                  num_classes: int, overlap_threshold: float = 0.5,
                  neg_pos_ratio: float = 3.0, background_id: int = 0,
                  name: Optional[str] = None):
    """SSD training loss: matched-prior smooth-L1 localization + softmax
    confidence with hard negative mining (reference: multibox_loss_layer,
    MultiBoxLossLayer.cpp). input_loc/input_conf: layer(s) of per-prior
    predictions, concatenated to [B, P*4] and [B, P*num_classes]."""
    from paddle_tpu_torch.ops import detection as ops_det
    name = name or auto_name("multibox_loss")
    locs = _as_list(input_loc)
    confs = _as_list(input_conf)
    pbs = _as_list(priorbox)
    variances = pbs[0].variances

    def fwd(params, parents, ctx):
        nl, nc, npb = len(locs), len(confs), len(pbs)
        priors, loc, conf = _detection_heads(
            parents[:nl], parents[nl:nl + nc],
            parents[nl + nc:nl + nc + npb], num_classes)
        P = priors.shape[0]
        lab_v = parents[-1]
        gt = lab_v.array                                   # [B, G, 5]
        gt_valid = _lengths_mask(lab_v.lengths, gt.shape[1])
        ids = torch.arange(P, device=gt.device)

        def one(loc_b, conf_b, gt_b, valid_b):
            match, _ = ops_det.match_priors(priors, gt_b[:, 1:5], valid_b,
                                            overlap_threshold)
            pos = match >= 0
            npos = torch.sum(pos)
            safe_match = torch.clamp_min(match, 0).long()
            gt_box = gt_b[:, 1:5][safe_match]
            gt_cls = gt_b[:, 0][safe_match].to(torch.int32)
            target = ops_det.encode_boxes(gt_box, priors, variances)
            ad = torch.abs((loc_b - target).float())
            sl1 = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5).sum(-1)
            loc_loss = torch.sum(torch.where(pos, sl1, 0.0))
            # conf loss per prior, target = matched class or background
            tgt_cls = torch.where(pos, gt_cls, background_id)
            logp = torch.log_softmax(conf_b.float(), dim=-1)
            ce = -logp.gather(1, tgt_cls[:, None].long())[:, 0]
            # hard negative mining: top (ratio*npos) background priors by ce
            nneg = torch.minimum((neg_pos_ratio * npos).to(torch.int32),
                                 P - npos)
            neg_ce = torch.where(pos, float("-inf"), ce)
            order = torch.argsort(-neg_ce, stable=True)
            rank = torch.empty_like(order).scatter_(0, order, ids)
            neg = (~pos) & (rank < nneg)
            conf_loss = torch.sum(torch.where(pos | neg, ce, 0.0))
            denom = torch.clamp_min(npos.float(), 1.0)
            return (loc_loss + conf_loss) / denom

        return Value(torch.stack([one(*a) for a in
                                  zip(loc, conf, gt, gt_valid)]))

    return LayerOutput(name, "multibox_loss",
                       locs + confs + pbs + [label], fwd, [], size=1)


def detection_output(input_loc, input_conf, priorbox, num_classes: int,
                     nms_threshold: float = 0.45, nms_top_k: int = 400,
                     keep_top_k: int = 200,
                     confidence_threshold: float = 0.01,
                     background_id: int = 0, name: Optional[str] = None):
    """Decode + per-class NMS → [B, keep_top_k, 6] rows of
    (label, score, x1, y1, x2, y2), label −1 padding (reference:
    detection_output_layer / DetectionOutputLayer.cpp). NMS is the port's
    sync-free ``ops/detection.nms``."""
    from paddle_tpu_torch.ops import detection as ops_det
    name = name or auto_name("detection_output")
    locs = _as_list(input_loc)
    confs = _as_list(input_conf)
    pbs = _as_list(priorbox)
    variances = pbs[0].variances

    def fwd(params, parents, ctx):
        nl, nc = len(locs), len(confs)
        priors, loc, conf = _detection_heads(
            parents[:nl], parents[nl:nl + nc], parents[nl + nc:],
            num_classes)
        P = priors.shape[0]
        probs = torch.softmax(conf.float(), dim=-1)
        dev = loc.device

        def one(loc_b, probs_b):
            boxes = ops_det.decode_boxes(loc_b, priors, variances)
            per_k = max(1, min(nms_top_k, P))
            rows = []
            for cls in range(num_classes):
                if cls == background_id:
                    continue
                sel, sc = ops_det.nms(boxes, probs_b[:, cls], per_k,
                                      nms_threshold, confidence_threshold)
                bx = boxes[torch.clamp_min(sel, 0).long()]
                valid = sel >= 0
                rows.append(torch.cat([
                    torch.where(valid, cls, -1)[:, None].float(),
                    sc[:, None], bx.float()], dim=1))       # [per_k, 6]
            allr = torch.cat(rows, dim=0)               # [(C-1)*per_k, 6]
            if allr.shape[0] < keep_top_k:              # honor size contract
                pad = torch.zeros((keep_top_k - allr.shape[0], 6),
                                  device=dev)
                pad[:, 0] = -1.0
                allr = torch.cat([allr, pad], dim=0)
            order = torch.argsort(-torch.where(allr[:, 0] >= 0, allr[:, 1],
                                               float("-inf")), stable=True)
            return allr[order[:keep_top_k]]

        return Value(torch.stack([one(l, p) for l, p in zip(loc, probs)]))

    return LayerOutput(name, "detection_output", locs + confs + pbs, fwd,
                       [], size=keep_top_k * 6)


def roi_pool(input, rois, pooled_width: int, pooled_height: int,
             spatial_scale: float = 1.0, num_channels: Optional[int] = None,
             name: Optional[str] = None):
    """ROI max pooling (reference: roi_pool_layer / ROIPoolLayer.cpp).
    ``rois``: Value [B, R, 4] with lengths = #rois; output
    [B, R, pooled_h, pooled_w, C] (invalid rois are zero)."""
    from paddle_tpu_torch.ops import detection as ops_det
    name = name or auto_name("roi_pool")
    c, h, w = _img_in_shape(input)
    c = num_channels or c

    def fwd(params, parents, ctx):
        xv, rv = parents
        x = _to_nhwc(xv.array, c, h, w)
        rois_b = rv.array                                  # [B, R, 4]
        out = torch.stack([ops_det.roi_pool(f, r, pooled_height, pooled_width,
                                            spatial_scale)
                           for f, r in zip(x, rois_b)])
        if rv.lengths is not None:
            valid = _lengths_mask(rv.lengths, rois_b.shape[1])
            out = torch.where(valid[..., None, None, None], out, 0.0)
        return Value(out, rv.lengths)

    return LayerOutput(name, "roi_pool", [input, rois], fwd, [],
                       size=pooled_width * pooled_height * c)


# ---------------------------------------------------------------------------
# parity tail: lookahead/row conv, data norm, featmap expand, MDLSTM,
# remaining cost layers (reference: RowConvLayer.cpp, DataNormLayer.cpp,
# FeatureMapExpandLayer.cpp, MDLstmLayer.cpp, CostLayer.cpp)
# ---------------------------------------------------------------------------

def row_conv(input, context_len: int, act=None, name: Optional[str] = None,
             param_attr=None):
    """Lookahead (row) convolution over a sequence — DeepSpeech2's future
    context (reference: row_conv_layer, gserver/layers/RowConvLayer.cpp):
    out[t] = sum_k x[t+k] * w[k], per-feature weights [context_len, d]."""
    name = name or auto_name("row_conv")
    act_name = act_mod.resolve(act)
    attr = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                       else ParamAttr(), f"{name}.w")
    w_spec = ParamSpec(attr.name, (context_len, input.size), attr=attr,
                       fan_in=context_len)

    def fwd(params, parents, ctx):
        pv = parents[0]
        enforce.enforce(pv.is_sequence, "row_conv needs sequence input")
        out = ops_seq.row_conv(pv.array, pv.lengths, params[w_spec.name])
        return _apply_act(Value(out, pv.lengths, pv.sub_lengths), act_name)

    return LayerOutput(name, "row_conv", [input], fwd, [w_spec],
                       size=input.size, activation=act_name)


row_conv_layer = row_conv


def data_norm(input, strategy: str = "z-score", name: Optional[str] = None):
    """Normalise dense input by dataset statistics (reference:
    data_norm_layer, gserver/layers/DataNormLayer.cpp — strategies z-score,
    min-max, decimal-scaling). The statistics live in non-learned
    parameters '<name>.mean/.std/.min/.max/.decimal'."""
    name = name or auto_name("data_norm")
    enforce.enforce(strategy in ("z-score", "min-max", "decimal-scaling"),
                    f"unknown data_norm strategy {strategy!r}")
    d = input.size

    def const(suffix, value):
        return ParamSpec(
            f"{name}.{suffix}", (d,),
            attr=ParamAttr(initializer="constant", initial_value=value,
                           is_static=True))

    mean_s, std_s = const("mean", 0.0), const("std", 1.0)
    min_s, max_s = const("min", 0.0), const("max", 1.0)
    dec_s = const("decimal", 1.0)

    def fn(params, parents, ctx):
        x = parents[0].array
        xf = x.float()
        if strategy == "z-score":
            out = (xf - params[mean_s.name]) / torch.clamp_min(
                params[std_s.name], 1e-8)
        elif strategy == "min-max":
            out = (xf - params[min_s.name]) / torch.clamp_min(
                params[max_s.name] - params[min_s.name], 1e-8)
        else:
            out = xf / torch.clamp_min(params[dec_s.name], 1e-8)
        return out.to(x.dtype)

    return _simple_layer(name, "data_norm", [input], fn, d,
                         specs=[mean_s, std_s, min_s, max_s, dec_s])


def featmap_expand(input, num_filters: int, as_row_vector: bool = True,
                   name: Optional[str] = None):
    """Replicate each sample's feature row into num_filters channels
    (reference: featmap_expand, FeatureMapExpandLayer.cpp:22-37)."""
    name = name or auto_name("featmap_expand")

    def fn(params, parents, ctx):
        x = parents[0].array
        flat = x.reshape(x.shape[0], -1)
        if as_row_vector:
            return flat.repeat(1, num_filters)
        return torch.repeat_interleave(flat, num_filters, dim=-1)

    lo = _simple_layer(name, "featmap_expand", [input], fn,
                       input.size * num_filters)
    lo._out_channels = num_filters
    return lo


def mdlstmemory(input, size: int, shape=None, name: Optional[str] = None,
                reverse_x: bool = False, reverse_y: bool = False,
                param_attr=None, bias_attr=True):
    """Multi-dimensional (2-D) LSTM over a feature map (reference:
    mdlstmemory, gserver/layers/MDLstmLayer.cpp — Graves MDLSTM; five gates
    with one forget gate per spatial dimension). ``shape``=(C, H, W) of the
    input when it cannot be inferred."""
    name = name or auto_name("mdlstm")
    if shape is not None:
        cin, ih, iw = shape
    else:
        cin, ih, iw = _img_in_shape(input)
    a = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                    else ParamAttr(), f"{name}.w")
    w_ih = ParamSpec(f"{name}.w_ih", (cin, 5 * size), attr=a, fan_in=cin)
    w_hx = ParamSpec(f"{name}.w_hx", (size, 5 * size),
                     attr=_param_attr(ParamAttr(), f"{name}.w_hx"),
                     fan_in=size)
    w_hy = ParamSpec(f"{name}.w_hy", (size, 5 * size),
                     attr=_param_attr(ParamAttr(), f"{name}.w_hy"),
                     fan_in=size)
    bias = _bias_spec(name, 5 * size, bias_attr)
    specs = [w_ih, w_hx, w_hy] + ([bias] if bias else [])

    def fwd(params, parents, ctx):
        x = _to_nhwc(parents[0].array, cin, ih, iw)
        out = ops_rnn.mdlstm(
            x, params[w_ih.name], params[w_hx.name], params[w_hy.name],
            params[bias.name] if bias else None,
            reverse_x=reverse_x, reverse_y=reverse_y)
        return Value(out)

    lo = LayerOutput(name, "mdlstm", [input], fwd, specs,
                     size=size * ih * iw)
    lo._out_channels = size
    lo._img_shape = (ih, iw)
    return lo


def img_conv3d_transpose(input, filter_size, num_filters: int, shape,
                         num_channels: Optional[int] = None, stride=1,
                         act=None, name: Optional[str] = None,
                         param_attr=None, bias_attr=None):
    """3-D transposed convolution over DHW volumes; ``shape``=(C, D, H, W)
    of the input (reference: deconv3d, gserver/layers/Conv3DLayer.cpp
    DeConv3DLayer). ``lax.conv_transpose`` with SAME padding (XLA's
    asymmetric pads) and the kernel not flipped: output dims = input dims
    * stride."""
    name = name or auto_name("deconv3d")
    act_name = act_mod.resolve(act)
    cin, d, h, w = shape
    cin = num_channels or cin
    k = (filter_size,) * 3 if isinstance(filter_size, int) \
        else tuple(filter_size)
    s = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    attr = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                       else ParamAttr(), f"{name}.w")
    w_spec = ParamSpec(attr.name, k + (cin, num_filters), attr=attr,
                       fan_in=cin * k[0] * k[1] * k[2])
    bias = _bias_spec(name, num_filters, bias_attr)
    specs = [w_spec] + ([bias] if bias else [])
    od, oh, ow = d * s[0], h * s[1], w * s[2]

    def fwd(params, parents, ctx):
        x = _ndhwc(parents[0].array, cin, d, h, w)
        out = ops_conv.conv3d_transpose(x, params[w_spec.name].to(x.dtype),
                                        stride=s, padding="SAME")
        if bias:
            out = out + params[bias.name].to(out.dtype)
        return _apply_act(Value(_flat_cdhw(out)), act_name)

    lo = LayerOutput(name, "deconv3d", [input], fwd, specs,
                     size=num_filters * od * oh * ow, activation=act_name)
    lo.shape3d = (num_filters, od, oh, ow)
    return lo


def space_to_depth_conv(input, filter_size: int, num_filters: int,
                        num_channels: Optional[int] = None, act=None,
                        name: Optional[str] = None, param_attr=None,
                        bias_attr=False, block: int = 2, img_size=None):
    """Stride-``block`` conv computed as a stride-1 conv over
    space-to-depth input — numerically img_conv(stride=block,
    padding=k//2); weights stored in the canonical [k, k, Cin, Cout]
    layout (ops/conv.space_to_depth_conv_transform)."""
    name = name or auto_name("s2d_conv")
    act_name = act_mod.resolve(act)
    cin = num_channels or getattr(input, "_out_channels", None)
    enforce.enforce(cin is not None,
                    f"s2d_conv {name}: num_channels required")
    ih, iw = _infer_img_shape(input, cin, img_size)
    enforce.enforce(ih is not None and ih % block == 0 and
                    iw % block == 0,
                    f"s2d_conv {name}: image size {ih}x{iw} must be known "
                    f"and divisible by block={block} (pass img_size=)")
    k = filter_size
    attr = _param_attr(param_attr if isinstance(param_attr, ParamAttr)
                       else ParamAttr(initializer="msra"), f"{name}.w")
    w_spec = ParamSpec(attr.name, (k, k, cin, num_filters), attr=attr,
                       fan_in=cin * k * k)
    bias = _bias_spec(name, num_filters, bias_attr)
    specs = [w_spec] + ([bias] if bias else [])
    oh, ow = ih // block, iw // block

    def fwd(params, parents, ctx):
        x = _to_nhwc(parents[0].array, cin, ih, iw)
        xs = ops_conv.space_to_depth(x, block)
        ws, pads = ops_conv.space_to_depth_conv_transform(
            params[w_spec.name], block)
        out = ops_conv.conv2d(xs, ws, stride=1, padding=pads)
        if bias:
            out = out + params[bias.name].to(out.dtype)
        return _apply_act(Value(out), act_name)

    lo = LayerOutput(name, "s2d_conv", [input], fwd, specs,
                     size=oh * ow * num_filters, activation=act_name)
    lo._out_channels = num_filters
    lo._img_shape = (oh, ow)
    return lo


def huber_regression_cost(input, label, delta: float = 1.0,
                          name: Optional[str] = None):
    """(reference: huber_regression_cost, HuberRegressionLoss)"""
    name = name or auto_name("huber_regression")

    def per_example(params, parents, ctx):
        return ops_loss.huber_regression(parents[0].array,
                                         parents[1].array, delta)

    return _cost_layer(name, "huber_regression", [input, label], per_example)


def smooth_l1_cost(input, label, name: Optional[str] = None):
    """(reference: smooth_l1_cost, SmoothL1CostLayer; smooth_l1_loss_op.cc)"""
    name = name or auto_name("smooth_l1")

    def per_example(params, parents, ctx):
        return ops_loss.smooth_l1(parents[0].array, parents[1].array)

    return _cost_layer(name, "smooth_l1", [input, label], per_example)


def soft_binary_class_cross_entropy(input, label, name: Optional[str] = None):
    """Per-dim binary CE with soft (probability) labels (reference:
    soft_binary_class_cross_entropy, SoftBinaryClassCrossEntropy)."""
    name = name or auto_name("soft_binary_ce")

    def per_example(params, parents, ctx):
        return ops_loss.multi_binary_cross_entropy(parents[0].array,
                                                   parents[1].array)

    return _cost_layer(name, "soft_binary_ce", [input, label], per_example)


def cross_entropy_with_selfnorm(input, label, alpha: float = 0.1,
                                name: Optional[str] = None):
    """CE plus alpha*log(Z)^2 self-normalisation (reference:
    cross_entropy_with_selfnorm, CostLayer.cpp:105). Needs the input
    layer's logits (softmax activation keeps them)."""
    name = name or auto_name("ce_selfnorm")

    def per_example(params, parents, ctx):
        pv, lv = parents
        logits = pv.pre_act if pv.pre_act is not None else pv.array
        return ops_loss.cross_entropy_with_selfnorm(
            logits, lv.array.reshape(-1), alpha)

    return _cost_layer(name, "ce_selfnorm", [input, label], per_example)


def sum_cost_layer(input, name: Optional[str] = None):
    """Cost = sum of the input row (reference: sum_cost, SumCostLayer)."""
    name = name or auto_name("sum_cost")

    def per_example(params, parents, ctx):
        return torch.sum(parents[0].array.float(), dim=-1)

    return _cost_layer(name, "sum_cost", [input], per_example)


def lambda_cost(input, score, ndcg_num: int = 5,
                name: Optional[str] = None):
    """LambdaRank NDCG cost over each query sequence (reference:
    lambda_cost, gserver CostLayer.h:252 LambdaCost). ``input`` is the
    model score sequence, ``score`` the relevance sequence."""
    name = name or auto_name("lambda_cost")

    def per_example(params, parents, ctx):
        pv, rv = parents
        enforce.enforce(pv.is_sequence, "lambda_cost needs sequence input")
        s = pv.array[..., 0] if pv.array.dim() == 3 else pv.array
        r = rv.array[..., 0] if rv.array.dim() == 3 else rv.array
        return ops_loss.lambda_rank(s, r, pv.lengths, ndcg_num)

    return _cost_layer(name, "lambda_cost", [input, score], per_example)


# install call recording over this module's public API so built graphs are
# serializable (Topology.to_dict/from_dict — the program save format)
def _install_recording():
    import sys
    from paddle_tpu_torch import record
    record.install(sys.modules[__name__])


_install_recording()
