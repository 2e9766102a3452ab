"""File-level wrapper tests (reference analog: test/wrapper_test.jl):
round-trip PLINK files, phenotype-source equivalence, cross-format oracle."""

import os

import numpy as np
import pytest

import mendeliht as m

REFDATA = "/root/reference/data"


@pytest.fixture()
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


class TestPhenotypeSources:
    """iht() must give identical results whether phenotypes come from the .fam
    column or a separate file (reference test/wrapper_test.jl:31-96)."""

    def test_fam_vs_file(self, in_tmp, rng):
        # write a PLINK trio whose .fam carries y, and the same y as a file
        # (note: the reference repo's own phenotypes.txt and normal.fam col 6
        # hold DIFFERENT draws, so we simulate our own consistent pair)
        x, _ = m.simulate_random_snparray("w.bed", 200, 300, rng=rng)
        y, true_b, pos = m.simulate_random_response(x, 3, m.Normal(), rng=rng)
        m.make_bim_fam_files(x, y, "w")
        np.savetxt("w.phen", y.reshape(-1, 1), delimiter=",")
        r_fam = m.iht("w", 3, m.Normal, phenotypes=6, verbose=False)
        r_file = m.iht("w", 3, m.Normal, phenotypes="w.phen", verbose=False)
        np.testing.assert_allclose(r_fam.beta, r_file.beta, atol=1e-6)
        np.testing.assert_allclose(r_fam.c, r_file.c, atol=1e-6)
        assert r_fam.iter == r_file.iter

    def test_output_files(self, in_tmp):
        m.iht(f"{REFDATA}/normal", 8, m.Normal, phenotypes=6, verbose=False)
        assert os.path.isfile("iht.summary.txt")
        assert os.path.isfile("iht.beta.txt")
        lines = open("iht.beta.txt").read().splitlines()
        assert lines[0].split("\t") == ["chr", "pos", "SNPid", "ref", "alt",
                                        "Estimated_beta"]
        assert len(lines) == 10001
        # beta file must NOT be empty (the reference wrapper.jl:117 bug)
        nonzero = [l for l in lines[1:] if float(l.split("\t")[-1]) != 0]
        assert len(nonzero) == 8


class TestCrossFormat:
    """PLINK == VCF ingestion oracle (reference test/wrapper_test.jl:184-206)."""

    def test_summary_tee_verbose(self, in_tmp, capsys):
        """verbose iht() tees the signature, parameter banner and per-
        iteration progress lines into the summary file, followed by the
        result block (reference wrapper.jl:83-92 + fit.jl:194-196)."""
        m.iht(f"{REFDATA}/normal", 8, m.Normal, phenotypes=6, verbose=True)
        text = open("iht.summary.txt").read()
        assert "mendeliht" in text                      # signature banner
        assert "Sparsity parameter (k) = 8" in text         # parameter banner
        assert "Iteration 1: loglikelihood = " in text      # per-iteration tee
        assert "backtracks = " in text and "tol = " in text
        assert "IHT estimated 8 nonzero SNP predictors" in text  # result block
        # per-iteration lines also stream to stdout (reference fit.jl:196)
        out = capsys.readouterr().out
        assert "Iteration 1: loglikelihood = " in out

    def test_plink_equals_vcf_genotypes(self):
        from mendeliht.utils.wrapper import parse_genotypes
        Xp, *_ = parse_genotypes(f"{REFDATA}/normal")
        Xv, *_ = parse_genotypes(f"{REFDATA}/normal.vcf.gz")
        Gd = Xp.snparray.to_dense_standardized()
        np.testing.assert_allclose(Gd, Xv, atol=5e-7)

    def test_plink_equals_vcf_fit(self, in_tmp):
        # same phenotype source for both formats (fam col 6 differs from
        # phenotypes.txt in the reference repo's data)
        rp = m.iht(f"{REFDATA}/normal", 8, m.Normal,
                   phenotypes=f"{REFDATA}/phenotypes.txt", verbose=False)
        rv = m.iht(f"{REFDATA}/normal.vcf.gz", 8, m.Normal,
                   phenotypes=f"{REFDATA}/phenotypes.txt", verbose=False)
        assert set(np.flatnonzero(rp.beta)) == set(np.flatnonzero(rv.beta))
        np.testing.assert_allclose(rp.beta, rv.beta, atol=2e-3)

    def test_bgen_close_to_plink(self):
        from mendeliht.utils.wrapper import parse_genotypes
        try:
            Xb, *_ = parse_genotypes(f"{REFDATA}/normal.bgen")
        except NotImplementedError as e:
            pytest.skip(f"bgen features unsupported: {e}")
        Xp, *_ = parse_genotypes(f"{REFDATA}/normal")
        Gd = Xp.snparray.to_dense_standardized()
        # bgen probabilities are 8-16 bit quantized: looser tolerance
        assert Xb.shape == Gd.shape
        np.testing.assert_allclose(Xb, Gd, atol=5e-2)


class TestMultivariateWrapper:
    def test_mv_fit_and_files(self, in_tmp):
        res = m.iht(f"{REFDATA}/multivariate", 10, m.MvNormal,
                    phenotypes=[6, 7], verbose=False)
        assert res.traits == 2
        assert os.path.isfile("iht.cov.txt")
        Sig = np.loadtxt("iht.cov.txt")
        np.testing.assert_allclose(Sig, res.Sigma, rtol=1e-5)
        lines = open("iht.beta.txt").read().splitlines()
        assert lines[0].split("\t")[:5] == ["chr", "pos", "SNPid", "ref", "alt"]
        assert lines[0].split("\t")[5:] == ["beta_1", "beta_2"]
        # phenotype file source gives same result
        res2 = m.iht(f"{REFDATA}/multivariate", 10, m.MvNormal,
                     phenotypes=f"{REFDATA}/multivariate.phen", verbose=False)
        np.testing.assert_allclose(res.beta, res2.beta, atol=1e-5)

    def test_cross_validate_mv(self, in_tmp):
        mse = m.cross_validate(f"{REFDATA}/multivariate", m.MvNormal,
                               phenotypes=[6, 7], path=[5, 10], q=3,
                               verbose=False, rng=np.random.default_rng(0))
        assert len(mse) == 2 and np.all(mse > 0)
        assert os.path.isfile("cviht.summary.txt")


class TestSimRoundTrip:
    def test_write_read_plink(self, in_tmp, rng):
        x, mafs = m.simulate_random_snparray("sim.bed", 120, 60, rng=rng)
        y, true_b, pos = m.simulate_random_response(x, 3, m.Normal(), rng=rng)
        m.make_bim_fam_files(x, y, "sim")
        snp = m.read_plink("sim")
        assert snp.people == 120 and snp.snps == 60
        assert np.array_equal(snp.snparray.to_codes(), x.to_codes())
        # phenotype readable from fam column 6
        y_parsed = m.parse_phenotypes(snp, 6, m.Normal())
        np.testing.assert_allclose(y_parsed, y, rtol=1e-10)

    def test_parse_covariates_standardizes(self, in_tmp, rng):
        z = np.column_stack([np.ones(50), rng.standard_normal(50) * 9 + 3])
        np.savetxt("cov.txt", z, delimiter=",")
        out = m.parse_covariates("cov.txt", ())
        np.testing.assert_allclose(out[:, 0], 1.0)
        assert abs(out[:, 1].mean()) < 1e-10
        assert abs(out[:, 1].std(ddof=1) - 1) < 1e-10


class TestDelimiterSniffing:
    """Comma-, tab-, and whitespace-separated phenotype/covariate files all
    parse identically (the reference reads them via readdlm, which sniffs
    the separator: src/wrapper.jl:136-218, :228-247)."""

    def test_phenotypes_any_delimiter(self, in_tmp, rng):
        from mendeliht.utils.wrapper import parse_phenotypes

        Y = rng.standard_normal((40, 2))
        for name, d in [("p.csv", ","), ("p.tsv", "\t"), ("p.phen", " ")]:
            np.savetxt(name, Y, delimiter=d)
        a = parse_phenotypes(None, "p.csv", m.MvNormal())
        b = parse_phenotypes(None, "p.tsv", m.MvNormal())
        c = parse_phenotypes(None, "p.phen", m.MvNormal())
        np.testing.assert_allclose(b, a)
        np.testing.assert_allclose(c, a)
        # single-column (univariate) whitespace file — common PLINK .phen
        np.savetxt("u.phen", Y[:, 0])
        u = parse_phenotypes(None, "u.phen", m.Normal())
        np.testing.assert_allclose(u, Y[:, 0], atol=1e-12)

    def test_covariates_any_delimiter(self, in_tmp, rng):
        from mendeliht.utils.wrapper import parse_covariates

        Z = np.column_stack([np.ones(40), rng.standard_normal((40, 2))])
        for name, d in [("z.csv", ","), ("z.tsv", "\t"), ("z.txt", " ")]:
            np.savetxt(name, Z, delimiter=d)
        za = parse_covariates("z.csv")
        zb = parse_covariates("z.tsv")
        zc = parse_covariates("z.txt")
        np.testing.assert_allclose(zb, za)
        np.testing.assert_allclose(zc, za)

    def test_iht_whitespace_phen(self, in_tmp, rng):
        """End-to-end: iht() with a whitespace-separated phenotype file
        matches the comma-separated one exactly."""
        x, _ = m.simulate_random_snparray("w.bed", 200, 300, rng=rng)
        y, _, _ = m.simulate_random_response(x, 3, m.Normal(), rng=rng)
        m.make_bim_fam_files(x, y, "w")
        np.savetxt("w_comma.phen", y.reshape(-1, 1), delimiter=",")
        np.savetxt("w_ws.phen", y.reshape(-1, 1), delimiter=" ")
        r1 = m.iht("w", 3, m.Normal, phenotypes="w_comma.phen", verbose=False)
        r2 = m.iht("w", 3, m.Normal, phenotypes="w_ws.phen", verbose=False)
        np.testing.assert_allclose(r2.beta, r1.beta, atol=1e-7)
        np.testing.assert_allclose(r2.c, r1.c, atol=1e-7)
