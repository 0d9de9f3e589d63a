"""The dense LM family: config, modules, attention, transformer, step fns."""
