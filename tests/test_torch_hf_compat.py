"""HF-transformers checkpoint interop in paddle_tpu_torch: the cases of
``tests/test_hf_compat.py``, each held against a local ``transformers``
model and against ``paddle_tpu.models.hf_compat`` converting the same
state dict (CPU, fp32).

Logits and hidden states within rtol = atol = 2e-4 of ``transformers``
(the JAX test's limit; the two libraries sum in another order) and within
1e-5 of the JAX conversion; a round trip through the HF layout is the
identity on every weight, to the bit.  ``transformers`` is needed by these
tests only: the port never imports it.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import hf_compat as jax_hf
from paddle_tpu_torch.models.hf_compat import (ernie_config_from_transformers,
                                               ernie_from_transformers,
                                               ernie_to_transformers_state_dict,
                                               llama_config_from_transformers,
                                               llama_from_transformers,
                                               llama_to_transformers_state_dict)
from paddle_tpu_torch.nn import LayerNorm

transformers = pytest.importorskip("transformers")

HF_TOL = dict(rtol=2e-4, atol=2e-4)
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu")


def _tiny_hf(tie=False, kv_heads=2):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=kv_heads, max_position_embeddings=64,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=tie,
        attn_implementation="eager")
    torch.manual_seed(11)
    return transformers.LlamaForCausalLM(cfg).eval()


def _hf_logits(hf, ids):
    with torch.no_grad():
        return hf(torch.tensor(ids, dtype=torch.long)).logits.float().numpy()


def _sd(hf):
    return {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(getattr(x, "_data", x))


def _jax_forward(model, *arrays):
    """The JAX model's forward compiled whole (its eager one compiles op by op)."""
    out = paddle.jit.to_static(model)(*(paddle.to_tensor(a) for a in arrays))
    return tuple(_np(o) for o in out) if isinstance(out, (tuple, list)) else _np(out)


@pytest.mark.parametrize("tie", [False, True])
def test_logits_parity_from_transformers(tie):
    hf = _tiny_hf(tie=tie)
    model = llama_from_transformers(hf, **CPU)
    assert model.config.tie_word_embeddings == tie
    ids = np.random.default_rng(0).integers(0, 128, size=(2, 16)).astype(np.int32)
    with torch.no_grad():
        ours = _np(model(torch.from_numpy(ids)))
    np.testing.assert_allclose(ours, _hf_logits(hf, ids), **HF_TOL)
    jax_model = jax_hf.llama_from_transformers(hf)
    np.testing.assert_allclose(ours, _jax_forward(jax_model, ids), **JAX_TOL)


def test_gqa_fused_layout_roundtrip():
    """to_transformers(from_transformers(m)) is the identity on weights: the
    fused qkv / gate_up splits sit where the concatenation put them (GQA:
    hk != h), and nothing is dropped either way."""
    hf = _tiny_hf(kv_heads=2)
    back = llama_to_transformers_state_dict(llama_from_transformers(hf, **CPU))
    src = _sd(hf)
    assert set(src) == set(back)
    for name, t in back.items():
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), src[name], err_msg=name)
    jax_back = jax_hf.llama_to_transformers_state_dict(jax_hf.llama_from_transformers(hf))
    for name, a in jax_back.items():
        np.testing.assert_array_equal(back[name].numpy(), a, err_msg=name)
    hf2 = _tiny_hf()
    hf2.load_state_dict(back)
    ids = np.arange(10, dtype=np.int32)[None] % 128
    np.testing.assert_array_equal(_hf_logits(hf2, ids), _hf_logits(hf, ids))


def test_state_dict_input_with_explicit_config():
    hf = _tiny_hf()
    cfg = llama_config_from_transformers(hf.config)
    for sd in (_sd(hf), hf.state_dict()):                     # numpy or torch tensors
        model = llama_from_transformers(sd, config=cfg, **CPU)
        ids = np.arange(12, dtype=np.int32).reshape(1, 12) % 128
        with torch.no_grad():
            np.testing.assert_allclose(_np(model(torch.from_numpy(ids))), _hf_logits(hf, ids),
                                       **HF_TOL)


def test_config_override_plumbs_through():
    hf = _tiny_hf()
    model = llama_from_transformers(hf, use_flash_attention=False, **CPU)
    assert model.config.use_flash_attention is False
    assert vars(model.config) == vars(jax_hf.llama_config_from_transformers(
        hf.config, use_flash_attention=False))


def test_missing_key_reports_name():
    hf = _tiny_hf()
    sd = _sd(hf)
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="up_proj"):
        llama_from_transformers(sd, config=llama_config_from_transformers(hf.config), **CPU)


def test_the_model_lands_on_the_card_unless_asked(monkeypatch):
    hf = _tiny_hf()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_from_transformers(hf)


# ---------------------------------------------------------------------------
# ERNIE / BERT
# ---------------------------------------------------------------------------

def _tiny_hf_ernie(cls_head=False, num_labels=3, seed=5):
    cfg = transformers.ErnieConfig(
        vocab_size=120, hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=72, max_position_embeddings=64, type_vocab_size=2,
        use_task_id=False, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        num_labels=num_labels, attn_implementation="eager")
    torch.manual_seed(seed)
    cls = (transformers.ErnieForSequenceClassification if cls_head
           else transformers.ErnieModel)
    return cls(cfg).eval()


def test_ernie_encoder_parity():
    hf = _tiny_hf_ernie()
    model = ernie_from_transformers(hf, **CPU).eval()
    ids = np.random.default_rng(3).integers(0, 120, size=(2, 12)).astype(np.int32)
    tok = np.zeros_like(ids)
    with torch.no_grad():
        out = hf(torch.tensor(ids, dtype=torch.long), token_type_ids=torch.tensor(
            tok, dtype=torch.long))
        seq, pooled = model(torch.from_numpy(ids), torch.from_numpy(tok))
    np.testing.assert_allclose(_np(seq), out.last_hidden_state.numpy(), **HF_TOL)
    np.testing.assert_allclose(_np(pooled), out.pooler_output.numpy(), **HF_TOL)
    jseq, jpooled = _jax_forward(jax_hf.ernie_from_transformers(hf).eval(), ids, tok)
    np.testing.assert_allclose(_np(seq), jseq, **JAX_TOL)
    np.testing.assert_allclose(_np(pooled), jpooled, **JAX_TOL)


def test_ernie_classification_head_parity_and_roundtrip():
    hf = _tiny_hf_ernie(cls_head=True)
    model = ernie_from_transformers(hf, **CPU).eval()
    assert model.num_classes == 3
    ids = (np.arange(20, dtype=np.int32).reshape(2, 10) * 5) % 120
    with torch.no_grad():
        ref = hf(torch.tensor(ids, dtype=torch.long)).logits.numpy()
        got = _np(model(torch.from_numpy(ids)))
    np.testing.assert_allclose(got, ref, **HF_TOL)
    np.testing.assert_allclose(got, _jax_forward(jax_hf.ernie_from_transformers(hf).eval(), ids),
                               **JAX_TOL)
    back = ernie_to_transformers_state_dict(model)
    src = {k: v for k, v in _sd(hf).items() if k in back}
    assert set(src) == set(back)
    for name, t in back.items():
        np.testing.assert_array_equal(t.numpy(), src[name], err_msg=name)
    again = ernie_from_transformers(back, config=ernie_config_from_transformers(hf.config),
                                    **CPU).eval()
    hf2 = _tiny_hf_ernie(cls_head=True, seed=6)          # other weights, then the exported ones
    missing, unexpected = hf2.load_state_dict(back, strict=False)
    assert unexpected == [] and all("position_ids" in k for k in missing)
    with torch.no_grad():
        np.testing.assert_array_equal(_np(again(torch.from_numpy(ids))), got)
        np.testing.assert_array_equal(hf2(torch.tensor(ids, dtype=torch.long)).logits.numpy(),
                                      ref)


def test_ernie_bert_checkpoint_also_loads():
    """BERT shares the layout; the converter accepts bert.* prefixes too."""
    cfg = transformers.BertConfig(
        vocab_size=99, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=32, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, attn_implementation="eager")
    torch.manual_seed(9)
    hf = transformers.BertModel(cfg).eval()
    model = ernie_from_transformers(hf, config=ernie_config_from_transformers(cfg),
                                    **CPU).eval()
    ids = np.arange(8, dtype=np.int32)[None] % 99
    with torch.no_grad():
        ref = hf(torch.tensor(ids, dtype=torch.long)).last_hidden_state.numpy()
        seq, _ = model(torch.from_numpy(ids))
    np.testing.assert_allclose(_np(seq), ref, **HF_TOL)


def test_ernie_task_type_checkpoint_rejected():
    hf = _tiny_hf_ernie()
    sd = _sd(hf)
    sd["embeddings.task_type_embeddings.weight"] = np.zeros((3, 48), np.float32)
    with pytest.raises(ValueError, match="use_task_id"):
        ernie_from_transformers(sd, config=ernie_config_from_transformers(hf.config), **CPU)


def test_explicit_config_plus_overrides_rejected():
    hf = _tiny_hf()
    with pytest.raises(ValueError, match="mutually exclusive"):
        llama_from_transformers(hf, config=llama_config_from_transformers(hf.config),
                                use_flash_attention=False, **CPU)


def test_ernie_eps_override_for_state_dicts():
    hf = _tiny_hf_ernie()
    m = ernie_from_transformers(_sd(hf), config=ernie_config_from_transformers(hf.config),
                                layer_norm_eps=1e-5, **CPU)
    assert {l.epsilon for l in m.modules() if isinstance(l, LayerNorm)} == {1e-5}
    m = ernie_from_transformers(hf, **CPU)
    assert {l.epsilon for l in m.modules() if isinstance(l, LayerNorm)} == {1e-12}


def test_ernie_unsupported_activation_rejected():
    """The encoder hardcodes exact gelu; a relu checkpoint is refused at
    conversion instead of computing wrong states."""
    cfg = transformers.BertConfig(vocab_size=99, hidden_size=32, num_hidden_layers=1,
                                  num_attention_heads=2, intermediate_size=64,
                                  hidden_act="relu", max_position_embeddings=32)
    with pytest.raises(ValueError, match="hidden_act"):
        ernie_config_from_transformers(cfg)


def test_ernie_relative_positions_rejected():
    cfg = transformers.BertConfig(vocab_size=99, hidden_size=32, num_hidden_layers=1,
                                  num_attention_heads=2, intermediate_size=64,
                                  position_embedding_type="relative_key",
                                  max_position_embeddings=32)
    with pytest.raises(ValueError, match="position_embedding_type"):
        ernie_config_from_transformers(cfg)


def test_multi_layer_classifier_head_rejected():
    """RoBERTa-style heads (classifier.dense + classifier.out_proj) get a
    descriptive error, not a bare KeyError on classifier.weight."""
    hf = _tiny_hf_ernie()
    sd = _sd(hf)
    sd["classifier.dense.weight"] = np.zeros((48, 48), np.float32)
    sd["classifier.out_proj.weight"] = np.zeros((3, 48), np.float32)
    with pytest.raises(ValueError, match="classifier head layout"):
        ernie_from_transformers(sd, config=ernie_config_from_transformers(hf.config), **CPU)
