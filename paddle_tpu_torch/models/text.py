"""The port's copy of ``paddle_tpu/models/text.py``, built with the
port's layer API under the same layer and parameter names.

Text / sequence benchmark models (reference: benchmark/paddle/rnn/rnn.py
LSTM text classification; v1_api_demo/quick_start configs)."""

from paddle_tpu_torch import activation, layer, networks, pooling


def lstm_text_classification(words, hidden_dim=256, class_num=2,
                             emb_dim=128, stacked_num=1):
    """Embedding -> (stacked) LSTM -> max-pool -> softmax
    (reference: benchmark/paddle/rnn/rnn.py)."""
    emb = layer.embedding(words, emb_dim, name="t_emb")
    tmp = emb
    for i in range(stacked_num):
        tmp = networks.simple_lstm(tmp, hidden_dim, name=f"t_lstm{i}")
    pooled = layer.pool(tmp, pooling_type=pooling.Max(), name="t_pool")
    return layer.fc(pooled, class_num, act=activation.Softmax(), name="t_out")


def text_conv_net(words, hidden_dim=128, class_num=2, emb_dim=128,
                  context_len=3):
    """Text CNN (reference: v1_api_demo/quick_start trainer_config.cnn.py)."""
    emb = layer.embedding(words, emb_dim, name="tc_emb")
    conv = networks.sequence_conv_pool(emb, context_len=context_len,
                                       hidden_size=hidden_dim,
                                       name="tc_conv")
    return layer.fc(conv, class_num, act=activation.Softmax(), name="tc_out")


def stacked_lstm_tagger(words, tag_num, vocab_size=None, emb_dim=64,
                        hidden_dim=128, depth=2):
    """Bidirectional stacked LSTM sequence tagger emitting per-token softmax
    (reference: v1_api_demo/sequence_tagging rnn_crf.py topology minus CRF;
    CRF variant lives with the CRF layer)."""
    emb = layer.embedding(words, emb_dim, name="tag_emb")
    fwd = networks.simple_lstm(emb, hidden_dim, name="tag_l0f")
    bwd = networks.simple_lstm(emb, hidden_dim, reverse=True, name="tag_l0b")
    tmp = layer.concat([fwd, bwd], name="tag_cat0")
    for i in range(1, depth):
        f = networks.simple_lstm(tmp, hidden_dim, name=f"tag_l{i}f")
        b = networks.simple_lstm(tmp, hidden_dim, reverse=True,
                                 name=f"tag_l{i}b")
        tmp = layer.concat([f, b], name=f"tag_cat{i}")
    return layer.fc(tmp, tag_num, act=activation.Softmax(), name="tag_out")
