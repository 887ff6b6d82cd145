"""Frozen operation counts of DeepSeek-V2-Lite's serving steps.

Two operations per multiply-add of every matrix product, each layer's
own. Per token and layer, latent attention's projections: ``Wq`` (d to
H·(nope + rope)), ``Wkv_a`` (d to r + rope), ``Wkv_b`` (r to H·(nope +
v)) in a prefill, ``Wo`` (H·v to d); the FFN: layer ``i <
first_dense_layers`` a SwiGLU of ``dense_d_ff``, every other the router,
``experts_per_token`` expert SwiGLUs of ``d_ff`` and the shared SwiGLU of
``shared_d_ff`` (capacity drops and empty slots are not counted). A
prefill's attention (``flash``, what
``flash_roofline.prefill`` reads): 2·(qk + v) per live causal (query,
key) pair and head, qk = nope + rope. A decode step's attention is the
absorbed form over the cache's valid positions: ``q_nope W_uk^T`` (2·H·
nope·r), the scores over the latent and the RoPE key (2·H·(r + rope) a
position), ``p c`` (2·H·r a position) and ``W_uv`` (2·H·r·v); it takes
no ``Wkv_b`` product of its own. The logits over the padded vocabulary
(a multiple of 256) of each sequence's last position. Norms, RoPE,
softmax and the router's bookkeeping are not counted.
"""


def _padded(m):
    return -(-m["vocab_size"] // 256) * 256


def _dims(m):
    a = m["mla"]
    return (m["d_model"], m["num_heads"], a["kv_lora_rank"],
            a["qk_nope_head_dim"], a["qk_rope_head_dim"], a["v_head_dim"])


def _ffn(m, layer):
    d = m["d_model"]
    if layer < m["first_dense_layers"]:
        return 3 * 2 * d * m["dense_d_ff"]
    moe = m["moe"]
    return (2 * d * moe["num_experts"]
            + moe["experts_per_token"] * 3 * 2 * d * m["d_ff"]
            + 3 * 2 * d * m["shared_d_ff"])


def prefill(m, batch, seq):
    """The serving prefill of ``batch`` sequences of ``seq`` tokens:
    ``total``, and ``flash``, attention's share."""
    d, H, r, nope, rope, v = _dims(m)
    proj = (2 * d * H * (nope + rope) + 2 * d * (r + rope)
            + 2 * r * H * (nope + v) + 2 * H * v * d)
    L = m["num_layers"]
    flash = L * batch * H * 2 * (nope + rope + v) * seq * (seq + 1) // 2
    total = (batch * seq * sum(proj + _ffn(m, i) for i in range(L))
             + flash + batch * 2 * d * _padded(m))
    return {"total": total, "flash": flash}


def decode(m, batch, valid):
    """One decode step of ``batch`` sessions over ``valid`` cache
    positions each."""
    d, H, r, nope, rope, v = _dims(m)
    proj = (2 * d * H * (nope + rope) + 2 * d * (r + rope)
            + 2 * H * nope * r + 2 * H * r * v + 2 * H * v * d)
    attn = 2 * H * (r + rope) * valid + 2 * H * r * valid
    return {"total": batch * (sum(proj + attn + _ffn(m, i)
                                  for i in range(m["num_layers"]))
                              + 2 * d * _padded(m))}
