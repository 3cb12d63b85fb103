"""The port's copy of ``paddle_tpu/models/seq2seq.py``, built with the
port's layer API under the same layer and parameter names.

Attention seq2seq (the seqToseq encoder-decoder family).

Reference: the seqToseq network used by demo/seqToseq + machine-translation
book test (gru_encoder_decoder with simple_attention; beam-search generation
via RecurrentGradientMachine / SWIG SequenceGenerator, api/PaddleAPI.h:1025).

Builds both graphs from one set of shared parameter names:
- ``seq2seq_train``: teacher-forced training cost via recurrent_group
- ``seq2seq_generate``: beam-search generation reusing the same parameters
"""

import paddle_tpu_torch.data_type as data_type
from paddle_tpu_torch import layer, networks


def _encoder(src_word_id, src_dict_dim: int, word_vec_dim: int,
             encoder_size: int):
    src_embedding = layer.embedding(
        src_word_id, size=word_vec_dim,
        param_attr=layer.ParamAttr(name="_source_language_embedding"))
    src_forward = networks.simple_gru(src_embedding, size=encoder_size,
                                      name="src_fwd_gru")
    src_backward = networks.simple_gru(src_embedding, size=encoder_size,
                                       reverse=True, name="src_bwd_gru")
    encoded_vector = layer.concat([src_forward, src_backward])
    with_proj = layer.fc(encoded_vector, size=encoder_size, act="linear",
                         bias_attr=False, name="encoded_proj",
                         param_attr=layer.ParamAttr(name="_encoded_proj.w"))
    return encoded_vector, with_proj, src_backward


def seq2seq_train(src_dict_dim: int, trg_dict_dim: int,
                  word_vec_dim: int = 32, encoder_size: int = 32,
                  decoder_size: int = 32):
    """Teacher-forced training graph → cost layer."""
    src = layer.data("source_language_word",
                     data_type.integer_value_sequence(src_dict_dim))
    trg = layer.data("target_language_word",
                     data_type.integer_value_sequence(trg_dict_dim))
    lbl = layer.data("target_language_next_word",
                     data_type.integer_value_sequence(trg_dict_dim))

    encoded_vector, encoded_proj, src_backward = _encoder(
        src, src_dict_dim, word_vec_dim, encoder_size)
    back_first = layer.first_seq(src_backward, name="enc_last")
    decoder_boot = layer.fc(back_first, size=decoder_size, act="tanh",
                            name="decoder_boot",
                            param_attr=layer.ParamAttr(name="_decoder_boot.w"))

    trg_embedding = layer.embedding(
        trg, size=word_vec_dim,
        param_attr=layer.ParamAttr(name="_target_language_embedding"))

    def step(enc, enc_proj, cur_word):
        gru = networks.gru_decoder_with_attention(
            enc, enc_proj, cur_word, decoder_size, decoder_boot,
            name="decoder_gru")
        return layer.fc(gru, size=trg_dict_dim, act="softmax",
                        name="decoder_out",
                        param_attr=layer.ParamAttr(name="_decoder_out.w"))

    decoded = layer.recurrent_group(
        step,
        input=[layer.StaticInput(encoded_vector, is_seq=True),
               layer.StaticInput(encoded_proj, is_seq=True),
               trg_embedding],
        name="decoder_group")
    return layer.classification_cost(decoded, lbl, name="seq2seq_cost")


def seq2seq_generate(src_dict_dim: int, trg_dict_dim: int,
                     word_vec_dim: int = 32, encoder_size: int = 32,
                     decoder_size: int = 32, beam_size: int = 3,
                     max_length: int = 30, bos_id: int = 0, eos_id: int = 1):
    """Beam-search generation graph sharing the training parameters."""
    src = layer.data("source_language_word",
                     data_type.integer_value_sequence(src_dict_dim))
    encoded_vector, encoded_proj, src_backward = _encoder(
        src, src_dict_dim, word_vec_dim, encoder_size)
    back_first = layer.first_seq(src_backward, name="enc_last")
    decoder_boot = layer.fc(back_first, size=decoder_size, act="tanh",
                            name="decoder_boot",
                            param_attr=layer.ParamAttr(name="_decoder_boot.w"))

    def step(enc, enc_proj, cur_word):
        gru = networks.gru_decoder_with_attention(
            enc, enc_proj, cur_word, decoder_size, decoder_boot,
            name="decoder_gru")
        return layer.fc(gru, size=trg_dict_dim, act="softmax",
                        name="decoder_out",
                        param_attr=layer.ParamAttr(name="_decoder_out.w"))

    return layer.beam_search(
        step,
        input=[layer.StaticInput(encoded_vector, is_seq=True),
               layer.StaticInput(encoded_proj, is_seq=True),
               layer.GeneratedInput(
                   size=trg_dict_dim,
                   embedding_name="_target_language_embedding",
                   embedding_size=word_vec_dim)],
        bos_id=bos_id, eos_id=eos_id, beam_size=beam_size,
        max_length=max_length, name="generated_word")
