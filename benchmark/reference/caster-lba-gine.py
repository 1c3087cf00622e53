"""The plain reference of configuration ``caster-lba-gine``: CASTER-DTA(2,2),
the LBA GVP protein tower and the GINE molecule tower under the joint head
(plain.py, which holds the equations; this file names the towers)."""
TOWERS = {"protein": "lbamodel", "molecule": "gine"}
