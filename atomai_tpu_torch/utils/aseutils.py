"""Coordinates -> VASP/POSCAR structure files.

The port's own copy of `atomai_tpu/utils/aseutils.py` (pure numpy and
text, so it carries over as it is): ase_obj_basic writes a cubic cell,
ase_obj_adv a custom one. The files are readable by ASE and VESTA, and
equal the JAX package's byte for byte; no ASE dependency.
"""

from typing import Dict, List, Union

import numpy as np


def _gather_atoms(coords_dict: Dict[int, np.ndarray], frame_number: int,
                  map_dict: Dict[int, str], px2ang: float):
    """Splits coordinates by atomic class and converts px -> angstrom."""
    all_atoms, length_coords = [], []
    for c_atom in range(len(map_dict)):
        c = coords_dict[frame_number]
        picked = np.array(c[c[:, -1] == c_atom], dtype=float)
        picked = picked * px2ang
        all_atoms.append(picked)
        length_coords.append(picked.shape[0])
    all_atoms_arr = np.concatenate(all_atoms, axis=0)
    return all_atoms_arr, length_coords


def _write_poscar(filepath: str, header: str, lattice_rows: List[str],
                  map_dict: Dict[int, str], length_coords: List[int],
                  atoms: np.ndarray) -> None:
    with open(str(filepath), "w") as f:
        f.write(header + "\n")
        f.write(" 1.0000 \n")
        for row in lattice_rows:
            f.write(row)
        for el in map_dict.values():
            f.write(" " + el + " ")
        f.write("\n")
        for s in length_coords:
            f.write(" " + str(s))
        f.write("\n")
        f.write("Cartesian \n")
        for row in atoms:
            f.write(str(row[0]) + "\t" + str(row[1]) + "\t" +
                    str(row[2]) + "\n")


def ase_obj_basic(coords_dict: Union[Dict[int, np.ndarray], np.ndarray],
                  frame_number: int, material_system: str,
                  map_dict: Dict[int, str], filepath: str,
                  px2ang: float) -> None:
    """Writes a cubic-cell POSCAR from predicted coordinates
    (reference `aseutils.py:16-97`)."""
    if isinstance(coords_dict, np.ndarray):
        coords_dict = {frame_number: coords_dict}
    all_atoms_arr, length_coords = _gather_atoms(
        coords_dict, frame_number, map_dict, px2ang)
    a_lattice = np.max(all_atoms_arr) + 0.2
    c_val = np.max(all_atoms_arr)
    all_atoms_arr[:, 2] = c_val
    lattice_rows = [
        "  " + str(a_lattice) + " 0.0000 0.0000 \n",
        "  0.0000 " + str(a_lattice) + " 0.0000 \n",
        "  0.0000 0.0000 " + str(a_lattice) + "\n",
    ]
    _write_poscar(filepath, str(material_system), lattice_rows, map_dict,
                  length_coords, all_atoms_arr)
    print("You have successfully created an ASE object. \n")
    print("This is a cubic cell of " + material_system + ". \n")
    print("Now you can read it in using ase.io.vasp.read_vasp. \n")


def ase_obj_adv(a_lattice: List[float], b_lattice: List[float],
                c_lattice: List[float],
                coords_dict: Union[Dict[int, np.ndarray], np.ndarray],
                frame_number: int, material_system: str,
                map_dict: Dict[int, str], filepath: str,
                px2ang: float) -> None:
    """Writes a custom-cell POSCAR from predicted coordinates
    (reference `aseutils.py:100-186`)."""
    if isinstance(coords_dict, np.ndarray):
        coords_dict = {frame_number: coords_dict}
    all_atoms_arr, length_coords = _gather_atoms(
        coords_dict, frame_number, map_dict, px2ang)
    c_val = np.max(all_atoms_arr)
    all_atoms_arr[:, 2] = c_val
    lattice_rows = [
        "  " + " ".join(str(v) for v in a_lattice) + "\n",
        "  " + " ".join(str(v) for v in b_lattice) + "\n",
        "  " + " ".join(str(v) for v in c_lattice) + "\n",
    ]
    _write_poscar(filepath, str(material_system), lattice_rows, map_dict,
                  length_coords, all_atoms_arr)
    print("You have successfully created an ASE object. \n")
    print("You have prepared " + material_system + ". \n")
    print("Now you can read it in using ase.io.vasp.read_vasp. \n")
