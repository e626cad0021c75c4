"""Curated NCBI taxonomy records for the Zymo mock community panel (copy
of hymet_tpu.data.zymo_taxonomy).

Covers every species of the reference's curated 26-genome panel
(reference ``case/truth/zymo_refs/refs.tsv`` + the truth profile's
lineages, ``case/truth/zymo_mc/truth_profile.cami.tsv``), with full
root-to-species paths. Used by the validation harness and tests when no
NCBI taxdump is on disk.
"""

from hymet_tpu_torch.taxonomy.db import TaxonomyDB

# (taxid, name, rank, parent)
ZYMO_TAXONOMY_RECORDS = [
    ("131567", "cellular organisms", "no rank", "1"),
    ("2", "Bacteria", "superkingdom", "131567"),
    ("2759", "Eukaryota", "superkingdom", "131567"),
    # bacilli / firmicutes
    ("1239", "Bacillota", "phylum", "2"),
    ("91061", "Bacilli", "class", "1239"),
    ("1385", "Bacillales", "order", "91061"),
    ("186826", "Lactobacillales", "order", "91061"),
    ("186817", "Bacillaceae", "family", "1385"),
    ("90964", "Staphylococcaceae", "family", "1385"),
    ("1653", "Listeriaceae", "family", "1385"),
    ("81852", "Enterococcaceae", "family", "186826"),
    ("33958", "Lactobacillaceae", "family", "186826"),
    ("1386", "Bacillus", "genus", "186817"),
    ("1279", "Staphylococcus", "genus", "90964"),
    ("1637", "Listeria", "genus", "1653"),
    ("1350", "Enterococcus", "genus", "81852"),
    ("2742598", "Limosilactobacillus", "genus", "33958"),
    ("1423", "Bacillus subtilis", "species", "1386"),
    ("1280", "Staphylococcus aureus", "species", "1279"),
    ("1639", "Listeria monocytogenes", "species", "1637"),
    ("1351", "Enterococcus faecalis", "species", "1350"),
    ("1613", "Limosilactobacillus fermentum", "species", "2742598"),
    # proteobacteria
    ("1224", "Pseudomonadota", "phylum", "2"),
    ("1236", "Gammaproteobacteria", "class", "1224"),
    ("91347", "Enterobacterales", "order", "1236"),
    ("72274", "Pseudomonadales", "order", "1236"),
    ("543", "Enterobacteriaceae", "family", "91347"),
    ("135621", "Pseudomonadaceae", "family", "72274"),
    ("561", "Escherichia", "genus", "543"),
    ("590", "Salmonella", "genus", "543"),
    ("286", "Pseudomonas", "genus", "135621"),
    ("562", "Escherichia coli", "species", "561"),
    ("28901", "Salmonella enterica", "species", "590"),
    ("287", "Pseudomonas aeruginosa", "species", "286"),
    # fungi
    ("4890", "Ascomycota", "phylum", "2759"),
    ("5204", "Basidiomycota", "phylum", "2759"),
    ("4891", "Saccharomycetes", "class", "4890"),
    ("155619", "Tremellomycetes", "class", "5204"),
    ("4892", "Saccharomycetales", "order", "4891"),
    ("5234", "Tremellales", "order", "155619"),
    ("4893", "Saccharomycetaceae", "family", "4892"),
    ("1964185", "Cryptococcaceae", "family", "5234"),
    ("4930", "Saccharomyces", "genus", "4893"),
    ("5206", "Cryptococcus", "genus", "1964185"),
    ("4932", "Saccharomyces cerevisiae", "species", "4930"),
    ("5207", "Cryptococcus neoformans", "species", "5206"),
    # strain used in tests
    ("511145", "Escherichia coli str. K-12 substr. MG1655", "strain", "562"),
]


def zymo_taxdb() -> TaxonomyDB:
    return TaxonomyDB.from_records(ZYMO_TAXONOMY_RECORDS)
