"""DrugBank XML -> records of small-molecule drugs with human protein
targets/enzymes (counterpart of caster_dta_tpu/inference/load_drugbank.py).

Behavioral spec: reference inference/load_drugbank.py:7-161: the same
columns (drugbank_id, name, groups, smiles, target_*/enzyme_* lists), zip or
xml input, humans-only target filter, FASTA header stripping. ``smiles`` is
one string, ``""`` when the drug has none, or the list when it has several.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
import zipfile

_FIELDS = ("superid", "supername", "id", "source", "name", "sequence")
COLUMNS = ("drugbank_id", "name", "groups", "smiles",
           *(f"{kind}_{f}" for kind in ("target", "enzyme") for f in _FIELDS))


def load_drugbank(drugbank_file: str) -> dict:
    """-> records, one row per small-molecule drug, in file order."""
    if drugbank_file.endswith(".zip"):
        with zipfile.ZipFile(drugbank_file) as z:
            xml_names = [n for n in z.namelist() if n.endswith(".xml")]
            if not xml_names:
                raise ValueError("No XML file found in the ZIP archive")
            with z.open(xml_names[0]) as f:
                tree = ET.parse(f)
    else:
        tree = ET.parse(drugbank_file)

    root = tree.getroot()
    ns = root.tag.split("}")[0] + "}"

    rows = {c: [] for c in COLUMNS}
    for drug in root:
        if drug.get("type") != "small molecule":
            continue
        rows["drugbank_id"].append(drug.findtext(f"{ns}drugbank-id[@primary='true']"))
        rows["name"].append(drug.findtext(f"{ns}name"))
        rows["groups"].append([g.text for g in drug.findall(f"{ns}groups/{ns}group")])
        props = drug.findall(f"{ns}calculated-properties/{ns}property")
        smiles = [p.findtext(f"{ns}value") for p in props
                  if p.findtext(f"{ns}kind") == "SMILES"]
        rows["smiles"].append(smiles[0] if len(smiles) == 1 else ("" if not smiles else smiles))

        for field, tag in (("target", "targets"), ("enzyme", "enzymes")):
            info = get_all_target_info(drug.findall(f"{ns}{tag}/"), ns=ns)
            for k, f in enumerate(_FIELDS):
                rows[f"{field}_{f}"].append([x[k] for x in info])
    return rows


def get_all_target_info(targets, ns="{http://www.drugbank.ca}"):
    out = []
    for parent in targets:
        if parent.findtext(f"{ns}organism") != "Humans":
            continue
        parent_id = parent.findtext(f"{ns}id")
        parent_name = parent.findtext(f"{ns}name")
        for poly in parent.findall(f"{ns}polypeptide"):
            out.append((parent_id, parent_name,
                        *get_single_target_info(poly, ns=ns)))
    return out


def get_single_target_info(el, ns="{http://www.drugbank.ca}"):
    seq = el.findtext(f"{ns}amino-acid-sequence") or ""
    seq = "".join(x for x in seq.split("\n") if not x.startswith(">"))
    return el.get("id"), el.get("source"), el.findtext(f"{ns}name"), seq
