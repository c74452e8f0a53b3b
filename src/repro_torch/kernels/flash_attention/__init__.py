"""Attention: prefill (causal/window, softcap, GQA) and decode (per-row kv_len)."""
