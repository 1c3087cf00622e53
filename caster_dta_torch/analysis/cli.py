"""The downstream analyses from the command line: the six root scripts of
the JAX package (test_biolip_binding.py, test_dta_variation.py,
test_protein_binders.py and visualize_{biolip,variation,binder}_results.py)
as subcommands, with their USER INPUTS as defaults.

    python analysis_torch.py biolip [--model-folder F] [--device cpu]
    python analysis_torch.py variation [--variants V.json] [--drugs D.json]
    python analysis_torch.py binders [--drugbank-file X | --drugs D.json]
    python analysis_torch.py visualize-biolip [--no-draw]
    python analysis_torch.py visualize-variation
    python analysis_torch.py visualize-binders [--percentile 99]

The analyses run on the card unless ``--device cpu``. Results are pickled
records under the JAX package's base names with ``_records``
(``biolip_raw_records.pkl``, ``pgx_raw_records.pkl``,
``pgx_delta_records.pkl``, ``ad_raw_records.pkl``, ``ad_topk_records.pkl``).
A JSON file for ``--variants``, ``--sequence-pairs`` or ``--drugs`` holds
the dict the script would (name -> rsID, name -> {ref_seq, alt_seq},
name -> SMILES). ``--no-draw`` computes and writes the statistics without
the figures, which need matplotlib.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

MODEL_FOLDER = "pretrained_model_downstream"
# PharmGKB VIP coding variants (reference test_dta_variation.py:29-50)
TEST_VARIANTS = {
    "SLCO1B1_var1_atorvastatin-simvastatin-pravastatin-rosuvastatin": "rs4149056",
    "SLCO1B1_var2_atorvastatin-rosuvastatin-methotrexate-pravastatin": "rs2306283",
    "TPMT_var1_mercaptopurine": "rs1800462",
    "VKORC1_var_warfarin": "rs61742245",
}
# FDA-approved drug SMILES (reference test_dta_variation.py:74-95)
TEST_DRUGS = {
    "Rosuvastatin": r"O[C@@H](C[C@H](CC(=O)O)O)/C=C/c1c(nc(nc1c1ccc(cc1)F)N(S(=O)(=O)C)C)C(C)C",
    "Methotrexate": r"OC(=O)CC[C@@H](C(=O)O)NC(=O)c1ccc(cc1)N(Cc1cnc2c(n1)c(N)nc(n2)N)C",
    "Sunitinib": r"CCN(CCNC(=O)c1c(C)[nH]c(c1C)/C=C/1\C(=O)Nc2c1cc(F)cc2)CC",
    "Metoprolol": r"COCCc1ccc(cc1)OCC(CNC(C)C)O",
    "Clopidogrel": r"COC(=O)[C@H](c1ccccc1Cl)N1CCc2c(C1)ccs2",
    "Efavirenz": r"FC([C@@]1(C#CC2CC2)OC(=O)Nc2c1cc(Cl)cc2)(F)F",
    "Warfarin": r"CC(=O)C[C@@H](C1=CC=CC=C1)C2=C(C3=CC=CC=C3OC2=O)O",
    "Mercaptopurine": r"Sc1ncnc2c1nc[nH]2",
    "Atorvastatin": r"O[C@@H](C[C@H](CC(=O)O)O)CCn1c(C(C)C)c(c(c1c1ccc(cc1)F)c1ccccc1)C(=O)Nc1ccccc1",
    "Pravastatin": r"CC[C@@H](C(=O)O[C@H]1C[C@H](O)C=C2[C@H]1[C@@H](CC[C@H](C[C@H](CC(=O)O)O)O)[C@H](C=C2)C)C",
    "Azathioprine": r"Cn1cnc(c1Sc1ncnc2c1nc[nH]2)N(=O)=O",
    "Midazolam": r"Clc1ccc2c(c1)C(=NCc1n2c(C)nc1)c1ccccc1F",
    "Risperidone": r"Fc1ccc2c(c1)onc2C1CCN(CC1)CCc1c(C)nc2n(c1=O)CCCC2",
}


def _json(path):
    with open(path) as f:
        return json.load(f)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="analysis_torch.py", description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="command", required=True)

    def task(name, results_dir, base_data_dir, batch):
        s = sub.add_parser(name)
        s.add_argument("--results-dir", default=results_dir)
        s.add_argument("--base-data-dir", default=base_data_dir)
        s.add_argument("--model-folder", default=MODEL_FOLDER)
        s.add_argument("--max-batch-size", type=int, default=batch)
        s.add_argument("--n-workers", type=int, default=0)
        s.add_argument("--device", default="cuda")
        return s

    s = task("biolip", "./biolip_results/default_run", "./data/biolip_data/", 16)
    s.add_argument("--biolip-file", default="./data/biolip_data/BioLiP_nr.txt.gz")
    s.add_argument("--biolip-ligand-file", default="./data/biolip_data/ligand.tsv.gz")
    s.add_argument("--do-api", action="store_true")
    s = task("variation", "./pgx_results/default_run", "./data/pgx_data/", 8)
    s.add_argument("--variants", help="JSON {name: rsID} (default: the script's four)")
    s.add_argument("--sequence-pairs", help="JSON {name: {ref_seq, alt_seq}} (default: none)")
    s.add_argument("--drugs", help="JSON {name: SMILES} (default: the script's thirteen)")
    s = task("binders", "./ad_results/default_run", "./data/ad_data/", 16)
    s.add_argument("--drugbank-file", default="./data/full database.xml")
    s.add_argument("--all-drugs", action="store_true", help="not only approved drugs")
    s.add_argument("--drugs", help="JSON {name: SMILES} in place of DrugBank")
    s.add_argument("--pdb-dir", help="the structures to screen (default: base-data-dir/pdb_files)")
    s.add_argument("--k-drugs", type=int, default=10)

    for name, results, out, extra in (
            ("visualize-biolip", "./biolip_results/default_run/biolip_raw_records.pkl",
             "./biolip_results/default_run/figures", "--base-score"),
            ("visualize-variation", "./pgx_results/default_run/pgx_delta_records.pkl",
             "./pgx_results/default_run/figures", None),
            ("visualize-binders", "./ad_results/default_run/ad_raw_records.pkl",
             "./ad_results/default_run/figures", "--percentile")):
        s = sub.add_parser(name)
        s.add_argument("--results-file", default=results)
        s.add_argument("--output-dir", default=out)
        s.add_argument("--no-draw", action="store_true", help="statistics only, no figures")
        if extra == "--base-score":
            s.add_argument("--base-score", default="attention",
                           help="attention or explanation (the protein_<score> column)")
        elif extra == "--percentile":
            s.add_argument("--percentile", type=float, default=99.0)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    cmd = args.command
    if cmd == "biolip":
        from caster_dta_torch.analysis.biolip import run_biolip_binding
        os.makedirs(args.base_data_dir, exist_ok=True)
        results = run_biolip_binding(args.model_folder, args.biolip_file,
                                     args.biolip_ligand_file, args.results_dir,
                                     args.base_data_dir, max_batch_size=args.max_batch_size,
                                     do_api=args.do_api, n_workers=args.n_workers,
                                     device=args.device)
        print(f"Saved {len(results.get('protein_id', []))} rows to "
              f"{args.results_dir}/biolip_raw_records.pkl")
        return results
    if cmd == "variation":
        from caster_dta_torch.analysis.variation import run_dta_variation
        results, deltas = run_dta_variation(
            args.model_folder, _json(args.variants) if args.variants else TEST_VARIANTS,
            _json(args.drugs) if args.drugs else TEST_DRUGS, args.results_dir,
            args.base_data_dir,
            test_sequence_pairs=_json(args.sequence_pairs) if args.sequence_pairs else {},
            max_batch_size=args.max_batch_size, n_workers=args.n_workers, device=args.device)
        print(f"Saved {len(results.get('protein_id', []))} raw rows and "
              f"{len(deltas.get('variant_id', []))} ref/alt deltas to {args.results_dir}")
        return results, deltas
    if cmd == "binders":
        from caster_dta_torch.analysis.binders import drugs_from_drugbank, run_protein_binders
        pdb_dir = args.pdb_dir or os.path.join(args.base_data_dir, "pdb_files")
        protids_to_files = {
            os.path.basename(f).replace(".pdb", ""): os.path.join(pdb_dir, f)
            for f in (os.listdir(pdb_dir) if os.path.isdir(pdb_dir) else [])
            if f.endswith(".pdb")}
        if args.drugs:
            test_drugs = _json(args.drugs)
        elif os.path.exists(args.drugbank_file):
            test_drugs = drugs_from_drugbank(args.drugbank_file, not args.all_drugs)
        else:
            raise FileNotFoundError(
                f"DrugBank file {args.drugbank_file} not found (requires a license); "
                "pass --drugs with a JSON dict of SMILES instead")
        results, topk = run_protein_binders(
            args.model_folder, protids_to_files, test_drugs, args.results_dir,
            args.base_data_dir, max_batch_size=args.max_batch_size, k_drugs=args.k_drugs,
            n_workers=args.n_workers, device=args.device)
        print(f"Screened {len(results.get('protein_id', []))} pairs; top-k saved to "
              f"{args.results_dir}")
        return results, topk

    from caster_dta_torch.analysis import visualize
    records, draw = _load(args.results_file), not args.no_draw
    if cmd == "visualize-biolip":
        out = visualize.visualize_biolip_results(records, args.output_dir, args.base_score,
                                                 draw=draw)
        print(out)
        return out
    if cmd == "visualize-variation":
        out = visualize.visualize_variation_results(records, args.output_dir, draw=draw)
        print(f"{'Wrote' if draw else 'Named'} {len(out)} variant-drug figure pairs in "
              f"{args.output_dir}")
        return out
    top, drawn = visualize.visualize_binder_results(records, args.output_dir,
                                                    args.percentile, draw=draw)
    print(f"{len(top.get('protein_id', []))} pairs above the {args.percentile}th percentile; "
          f"{len(drawn)} drawings in {args.output_dir}")
    return top, drawn


if __name__ == "__main__":
    from caster_dta_torch.device import pin_mkl_code_path

    pin_mkl_code_path()
    main()
