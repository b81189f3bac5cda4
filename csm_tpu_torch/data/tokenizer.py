"""Text tokenizer loading (own copy of ``csm_tpu/data/tokenizer.py``).

``load_llama3_tokenizer`` mirrors the reference helper (``train.py:283-300``):
the Llama-3.2-1B tokenizer with a ``TemplateProcessing`` post-processor that
wraps every encode in BOS…EOS.  Tokenization is host-side Rust, so the stock
implementation is kept and only re-wrapped.  ``transformers`` and
``tokenizers`` are imported inside the function only: a host without them
can still import the port and train with any tokenizer object that has
``encode(text, add_special_tokens=True)`` and ``eos_token_id``.
"""

from __future__ import annotations


def load_llama3_tokenizer(name_or_path: str = "meta-llama/Llama-3.2-1B",
                          local_files_only: bool = False):
    """Llama-3 tokenizer with BOS/EOS template wrapping.  Requires either
    network access to the HF hub or a local tokenizer directory;
    ``local_files_only`` reads only a local directory or the local HF
    cache, never the network."""
    from tokenizers.processors import TemplateProcessing
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(name_or_path, local_files_only=local_files_only)
    bos, eos = tokenizer.bos_token, tokenizer.eos_token
    tokenizer._tokenizer.post_processor = TemplateProcessing(
        single=f"{bos}:0 $A:0 {eos}:0",
        pair=f"{bos}:0 $A:0 {eos}:0 {bos}:1 $B:1 {eos}:1",
        special_tokens=[
            (bos, tokenizer.bos_token_id),
            (eos, tokenizer.eos_token_id),
        ],
    )
    return tokenizer
