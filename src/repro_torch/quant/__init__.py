"""GSE-SEM quantization of LM weights."""
