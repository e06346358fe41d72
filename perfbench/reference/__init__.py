"""The plain reference of the served models: reference/llama.py."""
