"""The plain reference of configuration ``caster-cpd-gatv2``: the CPD GVP
protein tower (encoder and autoregressive decoder layers) and the GATv2
molecule tower under CASTER-DTA's joint head (plain.py holds the
equations; this file names the towers)."""
TOWERS = {"protein": "cpdmodel", "molecule": "gatv2"}
