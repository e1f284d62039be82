"""`llm` CLI of the port — chat with llama-family models (reference src/llm.cpp:39-508).

Counterpart of ``onnxstream_tpu/cli/llm_main.py`` with the same flags, and
``--device`` (``cuda``, the default: the first card, or ``cpu``). REPL with
chatml (TinyLlama) / [INST] (Mistral) templating, greedy decoding, streamed
tokens, and a device-resident bucketed KV cache.
`--synthetic tiny` runs a small random-weight model for smoke testing.

    python -m onnxstream_tpu_torch.cli.llm_main --synthetic tiny --device cuda --prompt hello
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llm", description=__doc__)
    p.add_argument("--models-path", "-m", default="", help="folder with model weights (builder layout) + vocab.txt")
    p.add_argument("--hf-path", default="", help="local HuggingFace llama/mistral checkpoint directory")
    p.add_argument("--model", default="tinyllama", choices=["tinyllama", "mistral"])
    p.add_argument("--synthetic", choices=["tiny"], default="")
    p.add_argument("--prompt", default="", help="single-shot prompt (otherwise REPL)")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--compute-dtype", default="bfloat16", choices=["float32", "bfloat16", "float16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the first NVIDIA card (an error without one); cpu only when asked")
    p.add_argument("--ops-printf", action="store_true",
                   help="accepted for parity with the JAX CLI, which does not read it either; no effect")
    p.add_argument("--download", action="store_true",
                   help="fetch the model from HF into --models-path if missing (not in the port: refused)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.download:
        raise NotImplementedError("--download is not ported (ROADMAP Queue 1 item 9)")

    import torch

    from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY, MISTRAL, TINYLLAMA
    from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline
    from onnxstream_tpu_torch.models.llm.tokenizer import SentencePieceBPE
    from onnxstream_tpu_torch.runtime.config import default_device

    device = default_device() if args.device == "cuda" else torch.device("cpu")
    is_tiny = args.model == "tinyllama"
    if args.synthetic:
        cfg = LLAMA_TINY
        # byte-level vocab so any ASCII prompt tokenizes
        tokens = [(0, chr(i)) for i in range(256)]
        tok = SentencePieceBPE(tokens, special=["<s>", "</s>", "[PAD]", "<|im_start|>", "<|im_end|>"])
        pipe = LlamaPipeline(cfg, tokenizer=tok, compute_dtype="float32",
                             buckets=[32, 64, 128], is_tiny_chat=True, device=device)
    elif args.hf_path:
        # straight from a transformers checkpoint — no ONNX hop
        import transformers

        from onnxstream_tpu_torch.models.llm.hf import config_from_hf, weights_from_hf_state_dict

        # local_files_only: a path that is not a checkpoint directory fails
        # here instead of being looked up as a hub repo id
        hf = transformers.AutoModelForCausalLM.from_pretrained(args.hf_path, local_files_only=True)
        cfg = config_from_hf(hf.config)
        weights = weights_from_hf_state_dict(hf.state_dict(), cfg)
        del hf
        hf_tok = transformers.AutoTokenizer.from_pretrained(args.hf_path, local_files_only=True)

        class _HFTok:
            token2idx = hf_tok.get_vocab()
            idx2token = [hf_tok.convert_ids_to_tokens(i) for i in range(hf_tok.vocab_size)]

            def encode(self, text):
                return hf_tok.encode(text)

            def decode_token(self, tid):
                return hf_tok.decode([tid])

        pipe = LlamaPipeline(cfg, weights=weights, tokenizer=_HFTok(),
                             compute_dtype=args.compute_dtype, is_tiny_chat=is_tiny, device=device)
    elif args.models_path:
        import os

        import numpy as np

        cfg = TINYLLAMA if is_tiny else MISTRAL
        tok = SentencePieceBPE.from_file(os.path.join(args.models_path, "vocab.txt"), is_tiny=is_tiny)
        weights = {}
        model_txt = os.path.join(args.models_path, "model.txt")
        declared = {}
        if os.path.exists(model_txt):
            # the catalog models are the reference's fp16 graphs: each weight
            # ref in model.txt declares its dtype + shape — a blanket float32
            # read would misparse every fp16 .bin
            from onnxstream_tpu_torch.ir import parse_model_txt
            from onnxstream_tpu_torch.runtime.weights import _read_bin

            with open(model_txt) as f:
                gref = parse_model_txt(f.read())
            for op in gref.ops:
                for t in op.inputs:
                    if t.is_weight and t.name:
                        declared[t.name] = t
        for f in os.listdir(args.models_path):
            if not f.endswith(".bin"):
                continue
            path = os.path.join(args.models_path, f)
            spec = declared.get(f)
            if spec is not None:
                weights[f] = _read_bin(path, spec.dtype, spec.shape)
            else:
                weights[f] = np.fromfile(path, np.float32)
        pipe = LlamaPipeline(cfg, weights=weights, tokenizer=tok,
                             compute_dtype=args.compute_dtype, is_tiny_chat=is_tiny, device=device)
    else:
        print("error: provide --models-path or --synthetic", file=sys.stderr)
        return 2

    import codecs

    # incremental utf-8 assembly: byte-fallback tokens are partial sequences
    _inc = codecs.getincrementaldecoder("utf-8")("replace")

    def stream(tok_id: int) -> None:
        tk = pipe.tokenizer
        if hasattr(tk, "decode_token_bytes"):
            print(_inc.decode(tk.decode_token_bytes(tok_id)), end="", flush=True)
        else:
            print(tk.decode_token(tok_id), end="", flush=True)

    # warm-up forward (loads weights + plans; reference llm.cpp:442-454)
    print("Loading weights...", end="", flush=True)
    pipe.forward([1])
    pipe.reset()
    print(" done!")

    if args.prompt:
        t0 = time.time()
        out = pipe.chat_turn(args.prompt, args.max_new_tokens, stream=None)
        dt = time.time() - t0
        print(out)
        print(f"\n[{dt:.1f}s]", file=sys.stderr)
        return 0

    while True:
        try:
            prompt = input("\n>>> ")
        except (EOFError, KeyboardInterrupt):
            return 0
        t0 = time.time()
        text = pipe.chat_turn(prompt, args.max_new_tokens, stream=stream)
        if not sys.stdout.isatty():
            print(text, end="")
        ntok = len(pipe.tokenizer.encode(text)) if text else 0
        print(f"\n[{ntok} tokens, {ntok / max(time.time() - t0, 1e-9):.1f} tok/s]", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
