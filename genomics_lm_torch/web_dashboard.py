"""Streamlit dashboard over run artifacts (twin of ``scripts/web_dashboard.py``).

Run: ``streamlit run genomics_lm_torch/web_dashboard.py`` from the
directory that holds ``runs/``. All data assembly lives in
``genomics_lm_torch.dashboard`` (testable without a UI; its model pages run
on the CUDA card); this file is rendering only, and exits with a clear
message when Streamlit is not installed. The charts need pandas, which
Streamlit brings.
"""

from __future__ import annotations

import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a file by ``streamlit run``
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from genomics_lm_torch import dashboard as data  # noqa: E402


def main(device: str | None = None) -> None:
    """Render the dashboard; the model pages run on ``device`` (default: the
    CUDA card)."""
    try:
        import streamlit as st
    except ImportError:
        raise SystemExit(
            "streamlit is not installed in this environment; the dashboard's "
            "data layer is importable as genomics_lm_torch.dashboard and fully "
            "functional headlessly (pip install streamlit to render the UI)."
        )

    st.set_page_config(page_title="codon-LM dashboard", layout="wide")
    st.title("codon-LM dashboard")

    browser = data.run_browser_data("runs")
    if not browser["table"]:
        st.warning("no runs found under runs/")
        return
    run_ids = [row["run_id"] for row in browser["table"]]
    run_id = st.sidebar.selectbox("run", run_ids)
    run_dir = Path("runs") / run_id

    tabs = st.tabs(["overview", "curves", "playground", "attention",
                    "saliency", "embeddings"])

    with tabs[0]:
        st.dataframe(browser["table"])
        details = data.run_details_data(run_dir)
        st.json(details["run"].get("meta") or {})

    with tabs[1]:
        details = data.run_details_data(run_dir)
        series = details["series"]
        if series.get("epoch"):
            import pandas as pd

            frame = pd.DataFrame(series).set_index("epoch")
            cols = [c for c in ("train_loss", "val_loss") if c in frame]
            st.line_chart(frame[cols])
        else:
            st.info("no curves yet")

    with tabs[2]:
        dna = st.text_input("DNA prompt", "ATG")
        if st.button("next codon"):
            st.json(data.playground_next_codon(run_dir, dna, device=device))
        if st.button("generate"):
            st.json(data.playground_generate(run_dir, dna, device=device))
        st.subheader("3D DNAshape physical profile")
        if st.button("shape profile") and dna:
            import pandas as pd

            profile = data.shape_profile_data(dna)
            frame = pd.DataFrame({
                "Base Position": profile["positions"],
                "Minor Groove Width (Å)": profile["MGW"],
                "Roll (Bendability) (°)": profile["Roll"],
                "Electrostatic Potential (kT/e)": profile["EP"],
            })
            st.line_chart(frame, x="Base Position",
                          y=["Minor Groove Width (Å)",
                             "Roll (Bendability) (°)",
                             "Electrostatic Potential (kT/e)"])
        variant = st.text_input("synonymous variant (optional)", "")
        if st.button("compare shapes") and dna and variant:
            import pandas as pd

            comp = data.shape_comparison_data(dna, variant)
            n = comp["aligned_length"]
            for param, label in (("MGW", "MGW (Å)"), ("Roll", "Roll (°)"),
                                 ("EP", "EP (kT/e)")):
                frame = pd.DataFrame({
                    "Base Position": list(range(n)),
                    f"WT {label}": comp["wild_type"][param][:n],
                    f"Var {label}": comp["variant"][param][:n],
                })
                st.line_chart(frame, x="Base Position",
                              y=[f"WT {label}", f"Var {label}"])
            st.json({k: v for k, v in comp.items()
                     if k.startswith(("mean_abs_delta", "gc_"))})

    with tabs[3]:
        dna = st.text_input("attention prompt", "ATGAAACCC")
        layer = st.number_input("layer", value=-1)
        if st.button("show attention"):
            payload = data.attention_data(run_dir, dna, layer=int(layer), device=device)
            st.write("tokens:", payload["tokens"])
            for h in range(payload["attention"].shape[0]):
                st.write(f"head {h}")
                st.dataframe(payload["attention"][h])

    with tabs[4]:
        dna = st.text_input("saliency prompt", "ATGAAACCC")
        if st.button("compute saliency"):
            payload = data.saliency_data(run_dir, dna, device=device)
            import pandas as pd

            st.bar_chart(
                pd.DataFrame({"saliency": payload["saliency"]},
                             index=payload["tokens"])
            )

    with tabs[5]:
        raw = st.text_area("CDS sequences (one per line)",
                           "ATGAAACCCGGG\nATGTTTGATCTG")
        if st.button("embed + PCA"):
            sequences = [s.strip() for s in raw.splitlines() if s.strip()]
            payload = data.embeddings_data(run_dir, sequences, device=device)
            st.write(f"{payload['embeddings'].shape[0]} sequences × "
                     f"{payload['embeddings'].shape[1]} dims")
            if payload["pca"] is not None:
                import pandas as pd

                frame = pd.DataFrame(payload["pca"], columns=["PC1", "PC2"])
                frame["sequence"] = sequences[: len(frame)]
                st.scatter_chart(frame, x="PC1", y="PC2")
            else:
                st.info("need ≥2 sequences for PCA")


if __name__ == "__main__":
    main()
