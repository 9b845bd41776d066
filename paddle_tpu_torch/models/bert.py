"""BERT / ERNIE-base encoder for dygraph pretraining (counterpart of
``paddle_tpu/models/bert.py:22-231``).

The same layers, parameter names and layouts as the JAX model, so its
weights load one to one (:func:`~paddle_tpu_torch.dygraph.
load_state_dict_numpy`).  With ``fuse_attention`` (the default) the
attention runs through ``fused_multihead_attention``: on the card the
hand-written flash kernels of ``csrc/flash_attention.cu``, with the
attention-probs dropout inside them; ``fuse_attention=False`` is the
plain matmul / softmax / dropout / matmul composition.

Every model takes ``device`` (default "cuda", which raises without a
card) and draws its initial weights, its hidden dropout masks and its
attention dropout seeds from one ``torch.Generator`` on that device
(``generator``, else one seeded with ``seed``).

Under AMP (``dygraph.amp_guard``, ``jit_train_step(amp=True)``) the op
fronts cast at the JAX tracer's boundaries: the Linear / decoder
``matmul`` and ``fused_multihead_attention`` (q, k, v and the padding
bias) are white, ``softmax_with_cross_entropy`` (exempt under bf16),
``mean`` and the unfused path's ``softmax`` black.  ``einsum`` is on no
list: the q/k/v and out projections promote their operands as
``jnp.einsum`` does (:func:`_einsum`), so under O1 they run in f32, and
the out projection of the bf16 attention output with its f32 weight is
f32 too.  Elementwise ops promote as jnp does (bf16 + f32 -> f32).
"""
from __future__ import annotations

import math

import torch

from ..dygraph import Dropout, Embedding, Layer, LayerList, LayerNorm, Linear
from ..framework.place import resolve_device
from ..initializer import TruncatedNormalInitializer
from ..ops import nn_ops
from ..ops.decoder_ops import matmul
from ..ops.fused_ops import fused_multihead_attention
from ..param_attr import ParamAttr

__all__ = ["BertConfig", "MultiHeadAttention", "TransformerLayer",
           "BertModel", "BertForPretraining", "ErnieModel", "ErnieConfig"]


class BertConfig:
    """BERT-base by default (``google-bert/bert-base-uncased``): vocab
    30522, hidden 768, 12 layers of 12 heads, intermediate 3072, 512
    positions, dropout 0.1."""

    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, initializer_range=0.02,
                 fuse_attention=True, fuse_qkv=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range
        self.fuse_attention = fuse_attention
        self.fuse_qkv = fuse_qkv


def _einsum(equation, a, b):
    """``torch.einsum`` of two operands promoted to their common dtype
    first, as ``jnp.einsum`` promotes (``torch.einsum`` refuses mixed
    dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(equation, a.to(dt), b.to(dt))


def _init(cfg):
    return ParamAttr(initializer=TruncatedNormalInitializer(
        0.0, cfg.initializer_range))


class MultiHeadAttention(Layer):
    def __init__(self, cfg: BertConfig, device="cuda", generator=None):
        super().__init__()
        h = cfg.hidden_size
        kw = dict(device=device, generator=generator)
        self.n_head = cfg.num_attention_heads
        self.d_head = h // self.n_head
        self.fuse_qkv = cfg.fuse_qkv
        if self.fuse_qkv:
            self.qkv = Linear(h, 3 * h, param_attr=_init(cfg), **kw)
        else:
            self.q = Linear(h, h, param_attr=_init(cfg), **kw)
            self.k = Linear(h, h, param_attr=_init(cfg), **kw)
            self.v = Linear(h, h, param_attr=_init(cfg), **kw)
        self.out = Linear(h, h, param_attr=_init(cfg), **kw)
        self.drop = Dropout(cfg.attention_probs_dropout_prob,
                            dropout_implementation="upscale_in_train", **kw)
        self._fuse = cfg.fuse_attention
        self._generator = generator

    def forward(self, x, attn_mask=None, bias_qk=None):
        b, s, h = x.shape

        def split_heads(t):
            return t.reshape(b, s, self.n_head, self.d_head).permute(
                0, 2, 1, 3)

        def proj_heads(lin):
            # one einsum: projection + head split into [b, n, s, d]
            w = lin.weight.reshape(h, self.n_head, self.d_head)
            out = _einsum("bsh,hnd->bnsd", x, w)
            if lin.bias is not None:
                out = out + lin.bias.reshape(self.n_head, 1, self.d_head)
            return out

        if self.fuse_qkv:
            z = self.qkv(x)                   # [b, s, 3h]
            q = split_heads(z[:, :, :h])
            k = split_heads(z[:, :, h:2 * h])
            v = split_heads(z[:, :, 2 * h:])
        else:
            q, k, v = proj_heads(self.q), proj_heads(self.k), proj_heads(
                self.v)
        # bias_qk, when given, is the (b, kv) additive form of attn_mask
        # (BertModel derives both from one attention_mask)
        drop_active = self.training and self.drop._p > 0.0
        if self._fuse and (attn_mask is None or bias_qk is not None):
            # the kernels take contiguous (b, n, s, d); the einsum may
            # return a permuted view (JAX lays it out for free)
            ctx = fused_multihead_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                bias_qk=bias_qk, scale=1.0 / math.sqrt(self.d_head),
                dropout_rate=self.drop._p if drop_active else 0.0,
                generator=self._generator)
        else:
            scores = matmul(q, k, transpose_Y=True,
                            alpha=1.0 / math.sqrt(self.d_head))
            if attn_mask is not None:
                scores = scores + attn_mask
            probs = self.drop(nn_ops.softmax(scores, axis=-1))
            ctx = matmul(probs, v)
        # head merge + out-projection as one einsum from [b, n, s, d]
        w_out = self.out.weight.reshape(self.n_head, self.d_head, h)
        y = _einsum("bnsd,ndh->bsh", ctx, w_out)
        if self.out.bias is not None:
            y = y + self.out.bias
        return y


class TransformerLayer(Layer):
    def __init__(self, cfg: BertConfig, device="cuda", generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.attn = MultiHeadAttention(cfg, **kw)
        self.ln1 = LayerNorm(cfg.hidden_size, **kw)
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size,
                          param_attr=_init(cfg), act="gelu", **kw)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size,
                          param_attr=_init(cfg), **kw)
        self.ln2 = LayerNorm(cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.hidden_dropout_prob,
                            dropout_implementation="upscale_in_train", **kw)

    def forward(self, x, attn_mask=None, bias_qk=None):
        a = self.attn(x, attn_mask, bias_qk=bias_qk)
        x = self.ln1(x + self.drop(a))
        f = self.fc2(self.fc1(x))
        return self.ln2(x + self.drop(f))


def _generator(device, generator, seed):
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
    elif generator.device != dev:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    return dev, generator


class BertModel(Layer):
    def __init__(self, cfg: BertConfig, device="cuda", seed=0,
                 generator=None):
        super().__init__()
        dev, gen = _generator(device, generator, seed)
        kw = dict(device=dev, generator=gen)
        self.cfg = cfg
        self.word_emb = Embedding([cfg.vocab_size, cfg.hidden_size],
                                  param_attr=_init(cfg), **kw)
        self.pos_emb = Embedding([cfg.max_position_embeddings,
                                  cfg.hidden_size], param_attr=_init(cfg),
                                 **kw)
        self.type_emb = Embedding([cfg.type_vocab_size, cfg.hidden_size],
                                  param_attr=_init(cfg), **kw)
        self.emb_ln = LayerNorm(cfg.hidden_size, **kw)
        self.emb_drop = Dropout(cfg.hidden_dropout_prob,
                                dropout_implementation="upscale_in_train",
                                **kw)
        self.encoder = LayerList([TransformerLayer(cfg, **kw)
                                  for _ in range(cfg.num_hidden_layers)])
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size,
                             param_attr=_init(cfg), act="tanh", **kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        b, s = input_ids.shape
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(s, device=dev).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.long,
                                         device=dev)
        emb = (self.word_emb(input_ids) + self.pos_emb(position_ids)
               + self.type_emb(token_type_ids))
        x = self.emb_drop(self.emb_ln(emb))
        mask = bias2d = None
        if attention_mask is not None:
            # [b, s] 1/0 -> additive [b, 1, 1, s]; the 2D form feeds the
            # fused attention directly
            bias2d = (1.0 - attention_mask.float()) * -10000.0
            mask = nn_ops.unsqueeze2(nn_ops.unsqueeze2(bias2d, [1]), [1])
        for layer in self.encoder:
            x = layer(x, mask, bias_qk=bias2d)
        pooled = self.pooler(x[:, 0])
        return x, pooled


class BertForPretraining(Layer):
    """MLM + NSP heads; the MLM decoder is tied to the word embedding.
    ``nsp_labels=None`` trains the MLM loss alone."""

    def __init__(self, cfg: BertConfig, device="cuda", seed=0,
                 generator=None):
        super().__init__()
        dev, gen = _generator(device, generator, seed)
        kw = dict(device=dev, generator=gen)
        self.bert = BertModel(cfg, **kw)
        self.mlm_transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                    param_attr=_init(cfg), act="gelu", **kw)
        self.mlm_ln = LayerNorm(cfg.hidden_size, **kw)
        self.nsp = Linear(cfg.hidden_size, 2, param_attr=_init(cfg), **kw)

    def forward(self, input_ids, labels, token_type_ids=None,
                attention_mask=None, nsp_labels=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        h = self.mlm_ln(self.mlm_transform(seq))
        logits = matmul(h, self.bert.word_emb.weight, transpose_Y=True)
        loss = nn_ops.mean(nn_ops.softmax_with_cross_entropy(
            logits, nn_ops.unsqueeze2(labels, [2])))
        if nsp_labels is not None:
            loss = loss + nn_ops.mean(nn_ops.softmax_with_cross_entropy(
                self.nsp(pooled), nsp_labels))
        return loss


# ERNIE-base shares the BERT-base architecture
ErnieModel = BertModel
ErnieConfig = BertConfig
