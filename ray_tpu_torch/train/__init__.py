"""Single-device training: the AdamW optimizer and the Llama train step."""
