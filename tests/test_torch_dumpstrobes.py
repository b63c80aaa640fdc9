"""dumpstrobes-tpu-torch against dumpstrobes-tpu: byte-identical BED on a
multi-contig FASTA with N runs, lower case and a contig shorter than the
strobe window, for randstrobes and for syncmers."""

import pytest

from rabbitsalign_tpu.tools.dumpstrobes import main as jax_main
from rabbitsalign_tpu_torch.tools.dumpstrobes import main as port_main

from .util import random_dna


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    seqs = {
        "chr1": random_dna(4000, seed=1),
        "chr2 with a comment": random_dna(700, seed=2) + "N" * 25 + random_dna(900, seed=3).lower()
        + "NNNN" + random_dna(600, seed=4),
        "tiny": random_dna(30, seed=5),
        "repeat": random_dna(7, seed=6) * 150,
    }
    path = tmp_path_factory.mktemp("dumpstrobes") / "ref.fa"
    with open(path, "w") as f:
        for name, seq in seqs.items():
            f.write(f">{name}\n")
            f.write("\n".join(seq[i:i + 60] for i in range(0, len(seq), 60)) + "\n")
    return path


@pytest.mark.parametrize("flags", [[], ["--syncmers"], ["-r", "100", "-k", "18"]],
                         ids=["randstrobes", "syncmers", "r100-k18"])
def test_dumpstrobes_matches_jax(fasta, flags, capsys):
    assert port_main([*flags, str(fasta)]) == 0
    port_out = capsys.readouterr().out
    assert jax_main([*flags, str(fasta)]) == 0
    assert port_out == capsys.readouterr().out
    assert len(port_out.splitlines()) > 500
    assert {line.split("\t")[0] for line in port_out.splitlines()} >= {"chr1", "chr2", "repeat"}
