from pyscf_mpcc_tpu_torch.df.df import DF, make_auxmol
