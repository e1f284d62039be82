"""LLM family: llama-architecture graphs (TinyLlama/Mistral), tokenizer, chat."""
