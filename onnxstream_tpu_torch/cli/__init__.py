"""Command-line applications of the port: llm (chat)."""
