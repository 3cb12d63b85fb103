"""The port's copy of ``paddle_tpu/models/googlenet.py``, built with the
port's layer API under the same layer and parameter names.

GoogleNet / Inception-v1 (reference: benchmark/paddle/image/googlenet.py
— inception blocks via concat of 1x1/3x3/5x5/pool-proj branches)."""

from paddle_tpu_torch import activation, layer, pooling


def inception(input, ch_1x1, ch_3x3r, ch_3x3, ch_5x5r, ch_5x5, pool_proj,
              name):
    b1 = layer.img_conv(input, 1, ch_1x1, padding=0, act=activation.Relu(),
                        name=f"{name}_1x1")
    b2r = layer.img_conv(input, 1, ch_3x3r, padding=0, act=activation.Relu(),
                         name=f"{name}_3x3r")
    b2 = layer.img_conv(b2r, 3, ch_3x3, padding=1, act=activation.Relu(),
                        name=f"{name}_3x3")
    b3r = layer.img_conv(input, 1, ch_5x5r, padding=0, act=activation.Relu(),
                         name=f"{name}_5x5r")
    b3 = layer.img_conv(b3r, 5, ch_5x5, padding=2, act=activation.Relu(),
                        name=f"{name}_5x5")
    bp = layer.img_pool(input, 3, stride=1, padding=1,
                        pool_type=pooling.Max(), name=f"{name}_pool")
    bpp = layer.img_conv(bp, 1, pool_proj, padding=0, act=activation.Relu(),
                         name=f"{name}_poolproj")
    return layer.concat([b1, b2, b3, bpp], name=f"{name}_out")


def googlenet(input, class_num=1000):
    c1 = layer.img_conv(input, 7, 64, num_channels=3, stride=2, padding=3,
                        act=activation.Relu(), name="g_c1", img_size=224)
    p1 = layer.img_pool(c1, 3, stride=2, padding=1, pool_type=pooling.Max(),
                        name="g_p1")
    c2r = layer.img_conv(p1, 1, 64, padding=0, act=activation.Relu(),
                         name="g_c2r")
    c2 = layer.img_conv(c2r, 3, 192, padding=1, act=activation.Relu(),
                        name="g_c2")
    p2 = layer.img_pool(c2, 3, stride=2, padding=1, pool_type=pooling.Max(),
                        name="g_p2")
    i3a = inception(p2, 64, 96, 128, 16, 32, 32, "g_i3a")
    i3b = inception(i3a, 128, 128, 192, 32, 96, 64, "g_i3b")
    p3 = layer.img_pool(i3b, 3, stride=2, padding=1, pool_type=pooling.Max(),
                        name="g_p3")
    i4a = inception(p3, 192, 96, 208, 16, 48, 64, "g_i4a")
    i4b = inception(i4a, 160, 112, 224, 24, 64, 64, "g_i4b")
    i4c = inception(i4b, 128, 128, 256, 24, 64, 64, "g_i4c")
    i4d = inception(i4c, 112, 144, 288, 32, 64, 64, "g_i4d")
    i4e = inception(i4d, 256, 160, 320, 32, 128, 128, "g_i4e")
    p4 = layer.img_pool(i4e, 3, stride=2, padding=1, pool_type=pooling.Max(),
                        name="g_p4")
    i5a = inception(p4, 256, 160, 320, 32, 128, 128, "g_i5a")
    i5b = inception(i5a, 384, 192, 384, 48, 128, 128, "g_i5b")
    gap = layer.img_pool(i5b, 7, stride=1, pool_type=pooling.Avg(),
                         name="g_gap")
    drop = layer.dropout(gap, 0.4, name="g_drop")
    return layer.fc(drop, class_num, act=activation.Softmax(), name="g_out")
