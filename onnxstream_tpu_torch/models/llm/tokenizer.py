"""SentencePiece-score BPE tokenizer (reference src/llm.cpp:223-340).

vocab.txt format: one `score,token` per line; the line number is the id.
Byte tokens `<0xNN>` become single BYTES. The whole tokenizer operates on
UTF-8 BYTES, exactly like the reference's std::string walk (llm.cpp:288-340):
seeding per byte makes the `<0xNN>` byte-fallback correct for any input —
a codepoint walk would match 'é' (U+00E9) against the single byte <0xE9>
instead of its UTF-8 pair <0xC3><0xA9>, and crash on chars above U+00FF.
Encoding: greedy highest-score merge of adjacent tokens; special tokens are
matched longest-first before the byte-level seed. Chat templates: chatml
(TinyLlama) and [INST] (Mistral) (reference src/llm.cpp:465-467).

Counterpart of ``onnxstream_tpu/models/llm/tokenizer.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union


def _as_bytes(t: Union[str, bytes]) -> bytes:
    # surrogateescape round-trips vocab files with raw non-UTF-8 bytes
    return t if isinstance(t, bytes) else t.encode("utf-8", "surrogateescape")


class SentencePieceBPE:
    def __init__(self, tokens: List[Tuple[int, Union[str, bytes]]],
                 special: Optional[List[str]] = None):
        """tokens: list of (score, token_text) in id order."""
        self.idx2token: List[Tuple[int, bytes]] = [
            (s, _as_bytes(t)) for s, t in tokens]
        self.token2idx: Dict[bytes, int] = {t: i for i, (s, t) in enumerate(self.idx2token)}
        self.special_ids: List[int] = []
        for s in special or []:
            b = _as_bytes(s)
            if b not in self.token2idx:
                # TinyLlama appends [PAD]/<|im_start|>/<|im_end|> past the file
                # vocab (reference llm.cpp:264-275)
                self.token2idx[b] = len(self.idx2token)
                self.idx2token.append((0, b))
            self.special_ids.append(self.token2idx[b])

    @classmethod
    def from_file(cls, path: str, special: Optional[List[str]] = None, is_tiny: bool = False):
        tokens: List[Tuple[int, bytes]] = []
        with open(path, encoding="utf-8", errors="surrogateescape") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                comma = line.find(",")
                if comma == -1:
                    raise ValueError(f"invalid vocab line: {line[:50]!r}")
                score = int(line[:comma])
                token = line[comma + 1 :]
                if len(token) == 6 and token.startswith("<0x") and token.endswith(">"):
                    tb = bytes([int(token[3:5], 16) & 0xFF])
                else:
                    tb = _as_bytes(token)
                tokens.append((score, tb))
        sp = list(special or [])
        if is_tiny:
            sp = ["[PAD]", "<|im_start|>", "<|im_end|>"] + sp
        sp += ["<s>", "</s>"]
        return cls(tokens, sp)

    def encode(self, s: str) -> List[int]:
        """Greedy score-BPE over UTF-8 bytes (reference llm.cpp:288-340)."""
        bs = s.encode("utf-8")
        r: List[int] = []
        i = 0
        while i < len(bs):
            matched = False
            for j in self.special_ids:
                t = self.idx2token[j][1]
                if t and bs.startswith(t, i):
                    r.append(j)
                    i += len(t)
                    matched = True
                    break
            if matched:
                continue
            idx = self.token2idx.get(bs[i:i + 1])
            if idx is None:
                raise ValueError(
                    f"byte 0x{bs[i]:02x} not in vocab (byte tokens missing)")
            r.append(idx)
            i += 1

        while True:
            best_score = None
            best_id = -1
            best_k = -1
            for k in range(len(r) - 1):
                merged = self.idx2token[r[k]][1] + self.idx2token[r[k + 1]][1]
                idx = self.token2idx.get(merged)
                if idx is not None and (best_score is None or self.idx2token[idx][0] > best_score):
                    best_score = self.idx2token[idx][0]
                    best_id = idx
                    best_k = k
            if best_k == -1:
                break
            r[best_k] = best_id
            del r[best_k + 1]
        return r

    def decode_token_bytes(self, idx: int) -> bytes:
        """The raw piece bytes — join THESE before utf-8 decoding, because a
        multi-byte char's `<0xNN>` fallback tokens are partial sequences."""
        return self.idx2token[idx][1]

    def decode_token(self, idx: int) -> str:
        """Single-piece convenience view; partial utf-8 byte tokens show as
        U+FFFD — stream consumers should use decode_token_bytes with an
        incremental decoder (see cli/llm_main.py)."""
        return self.idx2token[idx][1].decode("utf-8", errors="replace")


def chat_template(prompt: str, is_tiny: bool, continuing: bool) -> str:
    """chatml for TinyLlama, [INST] for Mistral (reference src/llm.cpp:465-467)."""
    if is_tiny:
        return ("<|im_end|>\n" if continuing else "") + f"<|im_start|>user\n{prompt}<|im_end|>\n<|im_start|>assistant\n"
    return ("</s>" if continuing else "<s>") + f"[INST] {prompt} [/INST]"
