"""Frozen operation counts of a decoder's serving steps, from the
configuration's shapes alone.

Two operations per multiply-add of every matrix product: per token and
layer the products of ``token_layer(m)`` (each configuration's file,
``bench_port/flops/<config>.py``, gives its own); attention's two
products over the causal half in a prefill (4·hd per live (query, key)
pair and head) and over the cache's valid positions in a decode step;
the logits over the padded vocabulary (a multiple of 256) of each
sequence's last position. Norms, RoPE, softmax and a router's
bookkeeping are not counted.
"""
__all__ = ["decoder"]


def _padded(m):
    return -(-m["vocab_size"] // 256) * 256


def decoder(token_layer) -> tuple:
    """``prefill(m, batch, seq)`` and ``decode(m, batch, valid)`` of a
    decoder whose per-token, per-layer products ``token_layer(m)``
    counts."""

    def prefill(m, batch, seq):
        """The serving prefill of ``batch`` sequences of ``seq`` tokens:
        ``total``, and ``flash``, attention's share."""
        L, H, hd = m["num_layers"], m["num_heads"], m["head_dim"]
        flash = L * batch * H * 4 * hd * seq * (seq + 1) // 2
        total = (L * batch * seq * token_layer(m) + flash
                 + batch * 2 * m["d_model"] * _padded(m))
        return {"total": total, "flash": flash}

    def decode(m, batch, valid):
        """One decode step of ``batch`` sessions over ``valid`` cache
        positions each."""
        L, H, hd = m["num_layers"], m["num_heads"], m["head_dim"]
        return {"total": batch * (L * (token_layer(m) + 4 * hd * H * valid)
                                  + 2 * m["d_model"] * _padded(m))}

    return prefill, decode
