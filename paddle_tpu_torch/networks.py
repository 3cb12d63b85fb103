"""Composite network builders (counterpart of ``paddle_tpu/networks.py``;
reference: python/paddle/trainer_config_helpers/networks.py —
simple_img_conv_pool, simple_lstm, bidirectional_lstm, sequence_conv_pool,
simple_gru...)."""

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch import layer
from paddle_tpu_torch import pooling as pooling_mod


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         num_channel=None, pool_stride=None, act=None,
                         pool_type=None, name=None, padding=None):
    """(reference: networks.py simple_img_conv_pool)"""
    conv = layer.img_conv(input, filter_size=filter_size,
                          num_filters=num_filters, num_channels=num_channel,
                          act=act, padding=padding,
                          name=f"{name}_conv" if name else None)
    return layer.img_pool(conv, pool_size=pool_size, stride=pool_stride,
                          pool_type=pool_type,
                          name=f"{name}_pool" if name else None)


def simple_lstm(input, size, reverse=False, name=None, act=None,
                mat_param_attr=None, bias_param_attr=None,
                inner_param_attr=None):
    """fc(4*size) + lstmemory (reference: networks.py simple_lstm)."""
    proj = layer.fc(input, size * 4, param_attr=mat_param_attr,
                    bias_attr=False,
                    name=f"{name}_transform" if name else None)
    return layer.lstmemory(proj, size=size, reverse=reverse,
                           param_attr=inner_param_attr,
                           bias_attr=bias_param_attr,
                           name=name)


def simple_gru(input, size, reverse=False, name=None, act=None):
    """fc(3*size) + grumemory (reference: networks.py simple_gru)."""
    proj = layer.fc(input, size * 3, bias_attr=False,
                    name=f"{name}_transform" if name else None)
    return layer.grumemory(proj, size=size, reverse=reverse, name=name)


def bidirectional_lstm(input, size, name=None, return_seq=False):
    """Forward + backward LSTM, concat (reference: networks.py
    bidirectional_lstm)."""
    fwd = simple_lstm(input, size, reverse=False,
                      name=f"{name}_fw" if name else None)
    bwd = simple_lstm(input, size, reverse=True,
                      name=f"{name}_bw" if name else None)
    if return_seq:
        return layer.concat([fwd, bwd], name=name)
    last_f = layer.last_seq(fwd)
    first_b = layer.first_seq(bwd)
    return layer.concat([last_f, first_b], name=name)


def sequence_conv_pool(input, context_len, hidden_size, context_start=None,
                       pool_type=None, context_proj_name=None, fc_name=None,
                       pool_name=None, fc_act=None, name=None):
    """Text CNN block: context window -> fc -> seq pool (reference:
    networks.py sequence_conv_pool, the quick-start text model)."""
    ctx = layer.context_projection(input, context_len=context_len,
                                   context_start=context_start,
                                   name=context_proj_name)
    hidden = layer.fc(ctx, hidden_size, act=fc_act or act_mod.Tanh(),
                      name=fc_name)
    return layer.pool(hidden, pooling_type=pool_type or pooling_mod.Max(),
                      name=pool_name or name)


def img_conv_bn_pool(input, filter_size, num_filters, pool_size,
                     num_channel=None, pool_stride=None, act=None,
                     pool_type=None, name=None):
    """conv -> batch_norm -> pool (reference: networks.py img_conv_bn_pool)."""
    conv = layer.img_conv(input, filter_size=filter_size,
                          num_filters=num_filters, num_channels=num_channel,
                          act=None, bias_attr=False,
                          name=f"{name}_conv" if name else None)
    bn = layer.batch_norm(conv, act=act,
                          name=f"{name}_bn" if name else None)
    return layer.img_pool(bn, pool_size=pool_size, stride=pool_stride,
                          pool_type=pool_type,
                          name=f"{name}_pool" if name else None)


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     name=None, transform_param_attr=None):
    """Bahdanau-style additive attention inside a recurrent_group step.

    Reference: simple_attention (trainer_config_helpers/networks.py) — score
    each encoder position by tanh(enc_proj + W·state)·v via a sequence
    softmax, return the weighted sum of ``encoded_sequence``.

    ``encoded_sequence``/``encoded_proj`` are step placeholders fed from
    StaticInput(..., is_seq=True); ``decoder_state`` is a memory.
    """
    import torch

    from paddle_tpu_torch.core.param import ParamSpec, ParamAttr
    from paddle_tpu_torch.layer import _param_attr
    from paddle_tpu_torch.ops import sequence as ops_seq
    from paddle_tpu_torch.topology import LayerOutput, Value, auto_name

    name = name or auto_name("attention")
    proj_size = encoded_proj.size
    a = _param_attr(transform_param_attr, f"{name}.decoder_proj.w")
    w_spec = ParamSpec(a.name, (decoder_state.size, proj_size), attr=a,
                       fan_in=decoder_state.size)
    v_attr = ParamAttr(name=f"{name}.v")
    v_spec = ParamSpec(v_attr.name, (proj_size,), attr=v_attr,
                       fan_in=proj_size)

    def fwd(params, parents, ctx):
        enc, enc_proj, state = parents
        # enc.array [B, T, F]; state.array [B, H]
        dec = torch.matmul(state.array, params[w_spec.name])     # [B, P]
        e = torch.tanh(enc_proj.array + dec[:, None, :])         # [B, T, P]
        scores = torch.einsum("btp,p->bt", e, params[v_spec.name])
        w = ops_seq.seq_softmax(scores[..., None], enc.lengths)[..., 0]
        cvec = torch.einsum("bt,btf->bf", w, enc.array)
        return Value(cvec)

    return LayerOutput(name, "attention",
                       [encoded_sequence, encoded_proj, decoder_state],
                       fwd, [w_spec, v_spec], size=encoded_sequence.size)


def gru_decoder_with_attention(encoded_sequence, encoded_proj, current_word,
                               decoder_size, boot_layer, name="gru_decoder"):
    """One decoder step: attention context + previous word → GRU → softmax
    (reference: the seqToseq demo's gru_decoder_with_attention,
    v1_api_demo-era seqToseq_net). Use inside recurrent_group/beam_search."""
    state = layer.memory(name=name, size=decoder_size,
                         boot_layer=boot_layer)
    context = simple_attention(encoded_sequence, encoded_proj, state,
                               name=f"{name}_att")
    inputs = layer.fc([context, current_word], size=decoder_size * 3,
                      act="linear", name=f"{name}_input", bias_attr=False)
    gru = layer.gru_step(inputs, state=state, size=decoder_size, name=name)
    return gru


# composite nets are thin wrappers over recorded layer calls — the inner
# records suffice for serialization, but install anyway so composites whose
# inner calls are unrecordable still get a fallback record when possible
def img_conv_group(input, conv_num_filter, pool_size, num_channels=None,
                   conv_padding=1, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0,
                   pool_stride=None, pool_type=None, name=None):
    """Chain of convs (optionally BN + dropout each) ending in one pool
    (reference: networks.py img_conv_group — the VGG building block)."""
    def listify(v):
        return v if isinstance(v, (list, tuple)) \
            else [v] * len(conv_num_filter)

    pads = listify(conv_padding)
    ksz = listify(conv_filter_size)
    acts = listify(conv_act)
    bns = listify(conv_with_batchnorm)
    drops = listify(conv_batchnorm_drop_rate)
    tmp = input
    for i, nf in enumerate(conv_num_filter):
        lname = f"{name}_conv{i}" if name else None
        tmp = layer.img_conv(
            tmp, filter_size=ksz[i], num_filters=nf,
            num_channels=num_channels if i == 0 else None,
            padding=pads[i],
            act=None if bns[i] else (acts[i] or act_mod.Relu()),
            name=lname)
        if bns[i]:
            tmp = layer.batch_norm(tmp, act=acts[i] or act_mod.Relu(),
                                   name=f"{lname}_bn" if lname else None)
            if drops[i]:
                tmp = layer.dropout(tmp, drops[i])
    return layer.img_pool(tmp, pool_size=pool_size, stride=pool_stride or
                          pool_size, pool_type=pool_type,
                          name=f"{name}_pool" if name else None)


def small_vgg(input_image, num_channels, num_classes, name="svgg"):
    """(reference: networks.py small_vgg — the CIFAR VGG)"""
    tmp = input_image
    ch = num_channels
    for g, (nf, times, drop) in enumerate(
            [(64, 2, [0.3, 0]), (128, 2, [0.4, 0]),
             (256, 3, [0.4, 0.4, 0]), (512, 3, [0.4, 0.4, 0])]):
        tmp = img_conv_group(tmp, [nf] * times, pool_size=2,
                             num_channels=ch if g == 0 else None,
                             conv_with_batchnorm=True,
                             conv_batchnorm_drop_rate=drop,
                             name=f"{name}_g{g}")
        ch = None
    tmp = layer.dropout(tmp, 0.5)
    tmp = layer.fc(tmp, 512, act=None, name=f"{name}_fc1")
    tmp = layer.batch_norm(tmp, act=act_mod.Relu(), name=f"{name}_bn")
    return layer.fc(tmp, num_classes, act=act_mod.Softmax(),
                    name=f"{name}_out")


def vgg_16_network(input_image, num_channels, num_classes=1000,
                   name="vgg16"):
    """(reference: networks.py vgg_16_network)"""
    tmp = input_image
    ch = num_channels
    for g, (nf, times) in enumerate([(64, 2), (128, 2), (256, 3),
                                     (512, 3), (512, 3)]):
        tmp = img_conv_group(tmp, [nf] * times, pool_size=2,
                             num_channels=ch if g == 0 else None,
                             conv_act=act_mod.Relu(), name=f"{name}_g{g}")
        ch = None
    tmp = layer.fc(tmp, 4096, act=act_mod.Relu(), name=f"{name}_fc1")
    tmp = layer.dropout(tmp, 0.5)
    tmp = layer.fc(tmp, 4096, act=act_mod.Relu(), name=f"{name}_fc2")
    tmp = layer.dropout(tmp, 0.5)
    return layer.fc(tmp, num_classes, act=act_mod.Softmax(),
                    name=f"{name}_out")


def simple_gru2(input, size, reverse=False, name=None):
    """Pure alias of simple_gru (reference: networks.py simple_gru2 —
    same wiring; the reference variant differed only in mixed-layer
    parameter-attr defaults, which collapse to the same init here)."""
    return simple_gru(input, size, reverse=reverse, name=name)


def bidirectional_gru(input, size, return_seq=False, name=None):
    """Forward + backward GRU, concat (or concat of last steps)
    (reference: networks.py bidirectional_gru)."""
    fwd = simple_gru(input, size, name=f"{name}_fw" if name else None)
    bwd = simple_gru(input, size, reverse=True,
                     name=f"{name}_bw" if name else None)
    if return_seq:
        return layer.concat([fwd, bwd],
                            name=f"{name}_concat" if name else None)
    last_f = layer.last_seq(fwd)
    first_b = layer.first_seq(bwd)
    return layer.concat([last_f, first_b],
                        name=f"{name}_concat" if name else None)


def dot_product_attention(encoded_sequence, attended_sequence,
                          transformed_state, name=None):
    """Dot-product attention over an encoded sequence (reference:
    networks.py dot_product_attention): per-step scores
    ``<state, encoded[t]>``, masked sequence-softmax weights, context =
    weighted sum of the attended sequence."""
    import torch

    import paddle_tpu_torch.ops.sequence as ops_seq
    from paddle_tpu_torch.topology import LayerOutput, Value
    name = name or "dot_attn"

    def fwd(params, parents, ctx):
        state, enc, att = parents
        # [B, D] x [B, T, D] -> [B, T] scores
        s = torch.einsum("bd,btd->bt", state.array.float(), enc.array.float())
        w = ops_seq.seq_softmax(s[..., None], enc.lengths)[..., 0]
        ctxv = torch.einsum("bt,btd->bd", w, att.array.float())
        return Value(ctxv.to(att.array.dtype))

    return LayerOutput(name, "dot_attention",
                       [transformed_state, encoded_sequence,
                        attended_sequence],
                       fwd, [], size=attended_sequence.size)


def _install_recording():
    import sys
    from paddle_tpu_torch import record
    record.install(sys.modules[__name__])


_install_recording()
