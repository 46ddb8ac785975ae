"""Word -> token-position utilities for the learnable-token workflow.

The port's own copy of ``agenda_tpu/data/tokens.py`` (the port imports nothing of
agenda_tpu, not even its numpy-only modules).

``compute_token_merge_indices`` replicates the daam helper the reference's
``TokenDataset`` relies on (``data_generation/dataset.py:7,93``): find every
token position (BOS-offset) occupied by ``word`` in ``prompt``.

``insert_new_tokens`` replicates the prompt-rewrite loop
(``data_generation/dataset.py:89-97``): for each trigger word present in the
prompt, record the token start position of its first word, then splice the
corresponding new token immediately before the trigger word. Positions are
computed sequentially on the *rewritten* prompt so later triggers account for
earlier insertions, exactly as the reference does. Absent triggers record -1.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def compute_token_merge_indices(tokenizer, prompt: str, word: str) -> Tuple[List[int], None]:
    """All token indices (+1 for BOS) covering every occurrence of ``word``."""
    tokens = tokenizer.tokenize(prompt.lower())
    search = tokenizer.tokenize(word.lower())
    merge_idxs: List[int] = []
    for x in range(len(tokens)):
        if tokens[x : x + len(search)] == search:
            merge_idxs += list(range(x, x + len(search)))
    if not merge_idxs:
        raise ValueError(f"Search word {word} not found in prompt!")
    return [x + 1 for x in merge_idxs], None


def insert_new_tokens(
    tokenizer,
    prompt: str,
    word_tokens: Sequence[str],
    new_tokens: Sequence[str],
) -> Tuple[str, List[int]]:
    """Returns (rewritten_prompt, new_tokens_start).

    new_tokens_start[i] is the token position where new_tokens[i] lands in the
    rewritten prompt (== the recorded start of word_tokens[i]'s first word at
    rewrite time), or -1 when word_tokens[i] is absent.
    """
    starts: List[int] = []
    for word, new_token in zip(word_tokens, new_tokens):
        if word in prompt:
            first_word = word.split(" ")[0]
            idxs, _ = compute_token_merge_indices(tokenizer, prompt, first_word)
            starts += idxs
            prompt = prompt.replace(word, new_token + " " + word)
        else:
            starts.append(-1)
    return prompt, starts


def get_token_embeds(tokens, tokenizer, token_embedding_table):
    """Embedding rows for the given word(s), BOS/EOS stripped.

    Equivalent of the reference's utils_attndb.get_token_embeds (8-19):
    tokenize without padding, look up the embedding table, drop the first and
    last (BOS/EOS) rows. ``token_embedding_table`` is the (vocab, hidden)
    array from the text-encoder params.
    """
    import numpy as np

    if isinstance(tokens, list):
        tokens = " ".join(tokens)
    ids = [tokenizer._token_to_id(t) for t in tokenizer.tokenize(tokens)]
    return np.asarray(token_embedding_table)[np.asarray(ids, np.int64)]
